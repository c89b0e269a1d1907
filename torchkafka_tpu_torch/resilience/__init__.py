"""Crash-point registry (fault injection for durability tests)."""
