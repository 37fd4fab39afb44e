"""Training: losses and schedules, the pose bank, the train step."""
