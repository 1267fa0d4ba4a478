"""The PyTorch port's twins of the repo's operational scripts
(`scripts/encode_fine_grained.py`, `scripts/ingest_transcode.py`,
`scripts/judge_ab.py`): `python -m affectgpt_tpu_torch.scripts.<name>`."""
