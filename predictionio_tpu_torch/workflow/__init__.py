"""Workflow of the port: engine-instance persistence and model loading,
and training checkpoints (:mod:`.checkpoint`)."""
