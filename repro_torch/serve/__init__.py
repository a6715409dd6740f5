from repro_torch.serve.engine import TorchRequest, TorchServeEngine  # noqa: F401
