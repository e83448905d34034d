"""Measurement tools of the port (cafe_tpu/tools/ counterparts).

* `roofline` — achieved GB/s of each stage of the embedding hot path
  (lookup, optimizer apply, sketch query and insert) as a share of the
  card's peak memory bandwidth.
"""
