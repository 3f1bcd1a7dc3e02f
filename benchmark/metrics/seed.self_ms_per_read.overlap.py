from benchmark.spans import seed_self_ms as read  # noqa: F401
