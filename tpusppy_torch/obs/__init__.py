"""Observability: process-wide counters and the trace ring."""
