"""Commit bookkeeping: the per-partition offset ledger."""
