"""Workflow of the port: engine-instance persistence and model loading."""
