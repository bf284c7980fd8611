"""Serving runtime: micro-batching of concurrent requests."""
