"""Query-execution resilience for the local path (`resilience`)."""
