"""OV-MER zero-shot harness (the port's copy of the repo's ovmer/)."""
