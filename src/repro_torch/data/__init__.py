"""Synthetic datasets and federated partitions (numpy)."""
