"""PyTorch/CUDA port of `llm_mcp_tpu` for one NVIDIA H100.

The package mirrors the JAX package's layout (`models/`, `ops/`,
`kernels/`, `executor/`, `api/`, `utils/`) so each module's counterpart is
easy to find. It imports `torch` and never `jax` or `llm_mcp_tpu`: what it
needs from the JAX package it keeps as its own trimmed copy.

Every attention kernel on the serving path is a CUDA C++ kernel for
`sm_90a` (`kernels/csrc/`), built at first use and loaded with `ctypes`.
Entry points run on the card unless the caller passes `device="cpu"`;
on the CPU the kernel wrappers take their plain PyTorch versions.
"""
