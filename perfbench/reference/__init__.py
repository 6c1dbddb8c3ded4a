"""The plain references: each family's forward pass and weights, the
counts of its layers' shapes that ``perfbench/work.py`` reads, and the
curvature the traffic asks for."""
