"""Training of the port: schedules, optimizers and the train step."""
