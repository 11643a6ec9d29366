from repro_torch.configs.base import VectorPoolConfig  # noqa: F401
