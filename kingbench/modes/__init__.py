"""One window driver per mode, found by the mode's name."""
