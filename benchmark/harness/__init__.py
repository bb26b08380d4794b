"""The benchmark's harness: cells, traffic, weights, the served program's
window, the comparison that decides ``correct``, and the result line."""
