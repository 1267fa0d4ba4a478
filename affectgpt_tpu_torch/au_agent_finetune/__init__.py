"""AU-agent SFT data preparation and LoRA training (the port's copy of the
repo's au_agent_finetune/)."""
