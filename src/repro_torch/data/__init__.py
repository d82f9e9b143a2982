"""repro_torch.data — the counter-addressed synthetic token stream."""
