"""Engine templates of the port; the ALS recommendation template first."""
