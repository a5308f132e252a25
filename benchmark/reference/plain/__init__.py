"""A frozen copy of the port's plain paths (configuration, data, model,
clustering, evaluation and train step), with every kernel of the port
replaced by its plain PyTorch version on every device. Imported by the
reference alone; nothing of the port is imported here."""
