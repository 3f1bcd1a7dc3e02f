from benchmark.spans import turn_wait_ms as read  # noqa: F401
