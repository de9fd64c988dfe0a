from repro_torch.data.pipeline import SyntheticDataset  # noqa: F401
