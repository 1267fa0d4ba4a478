"""Worked adapters wrapping third-party MLLMs for the OV-MER zero-shot
harness (`affectgpt_tpu_torch.ovmer.zero_shot_harness.run_zero_shot`).

Importing a module here imports no `transformers`: each adapter loads its
HF model inside `build_model_fn`, and only when no pre-built model is
passed."""
