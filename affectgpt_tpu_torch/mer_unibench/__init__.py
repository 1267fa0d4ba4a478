"""MER-UniBench feature precompute (the port's copy of the repo's mer_unibench/)."""
