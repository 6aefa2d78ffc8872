"""The benchmark's own counts of the operations and bytes of the served
models' calls (one module an architecture, named by the configuration's
``arch``)."""
