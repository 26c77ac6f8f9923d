from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
