"""Command-line tools of the port (run each with `python -m
graphvite_tpu_torch.tools.<name>`): `row_access_bench`, the random-row-access
bench."""
