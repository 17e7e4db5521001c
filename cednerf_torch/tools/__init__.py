"""Tools of the port: profile_interp_enc (K1, K7 and K3 against
brick_encode's K5/K6 route), profile_row_gather (K8 against index_select),
validate_synthetic (dataset-free quality validation) and render_trace
(op-by-op digests of an evaluation frame: where two renders part). Each
runs as `python -m cednerf_torch.tools.<name>` and has a function for
callers.
"""
