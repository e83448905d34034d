"""Tools of the port (cafe_tpu/tools/ counterparts).

* `roofline` — achieved GB/s of each stage of the embedding hot path
  (lookup, optimizer apply, sketch query and insert) as a share of the
  card's peak memory bandwidth.
* `wire_audit`, `hlo_traffic` — every collective of one sharded step,
  and the analytic byte model it is held to.
* `export_model` — the eval step as a `torch.export` program.
* `job_scheduler`, `gen_tasks` — the task grids of tasks/*.json, one
  main_torch.py run each.
* `criteo_grid` — the Criteo-scale synthetic AUC grid.
* `process_interactions` — an events CSV to the graph recommenders'
  train.txt / test.txt.
* `visualization` — the boards' summaries and the reference's figures.
"""
