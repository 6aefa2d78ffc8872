"""Plain float32 PyTorch references of the served models (one module an
architecture, named by the configuration's ``arch``). They import nothing
of the port: they read the benchmark's own weights and inputs."""
