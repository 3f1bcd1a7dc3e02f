from benchmark.readers import device_idle as read  # noqa: F401
