"""The LLM stack of the port, every family of the JAX package's
(dense, moe, hybrid, ssm, vlm, audio); configs in
``repro_torch.configs``, serving in ``repro_torch.serve.engine``."""
