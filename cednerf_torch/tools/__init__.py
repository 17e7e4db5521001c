"""Probe tools of the port: profile_interp_enc (K1, K7 and K3 against
brick_encode's K5/K6 route) and profile_row_gather (K8 against
index_select). Each runs as `python -m cednerf_torch.tools.<name>` and has
a `run(...) -> dict` for callers."""
