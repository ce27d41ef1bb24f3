"""Models of the port; ALS serving first."""
