"""Single-device training of the port (the reference's ``repro.train``):
the loss, the step and the loop."""
