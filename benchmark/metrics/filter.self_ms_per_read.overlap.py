from benchmark.spans import filter_self_ms as read  # noqa: F401
