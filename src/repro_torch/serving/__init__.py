from repro_torch.serving.engine import ServeEngine, Request  # noqa: F401
