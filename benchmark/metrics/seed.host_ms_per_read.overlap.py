from benchmark.readers import seed_ms as read  # noqa: F401
