"""The dense transformer LLM stack of the port (configs in
``repro_torch.configs``, serving in ``repro_torch.serve.engine``)."""
