from benchmark.readers import filter_ms as read  # noqa: F401
