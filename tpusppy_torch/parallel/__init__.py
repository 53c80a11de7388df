"""Scenario-batch PH programs on the device (``tpusppy/parallel``): so far
the single-device wheel megastep (:mod:`.sharded`)."""
