from benchmark.readers import extend_decode_ms as read  # noqa: F401
