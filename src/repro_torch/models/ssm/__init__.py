"""The recurrent blocks of the LLM zoo: Mamba2 (`mamba2`) and RWKV6
(`rwkv6`), the JAX package's `models/ssm/`."""
