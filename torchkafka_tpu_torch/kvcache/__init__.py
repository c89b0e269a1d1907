"""KV-cache backend resolution for the serving pool."""
