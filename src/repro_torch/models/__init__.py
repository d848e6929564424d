"""The LM stack's serving half: the port's counterpart of ``repro/models``
for the dense decoder family."""
