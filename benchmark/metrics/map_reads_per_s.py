from benchmark.readers import reads_per_s as read  # noqa: F401
