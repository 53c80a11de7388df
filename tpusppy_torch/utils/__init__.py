"""Utilities of the port: the W/xbar file interchange (:mod:`.wxbarutils`)."""
