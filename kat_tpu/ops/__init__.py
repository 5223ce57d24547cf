"""Streaming table operations shared by the analysis phase: the bitonic
merge of two sorted key streams (ops/merge.py) and the sort-merge-join
lookup engine built on it (ops/join.py)."""
