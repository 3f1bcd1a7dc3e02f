from benchmark.spans import print_ms as read  # noqa: F401
