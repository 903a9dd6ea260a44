"""The port's tools, after the JAX package's experiments/: the trainers
`tune_gains` (gain tuning through a differentiable rollout),
`train_neural_rmp` (the learned reach attractor) and `train_neural_clutter`
(the learned obstacle leaf), and the entry points `evaluate` (the
evaluation sweep), `latency` (closed-loop latency), `soak` (the
long-horizon invariant check) and `run` (one scene, one env). Each runs as
a module, `python -m rmp_tpu_torch.experiments.<name> [--cpu] ...`, on the
card unless --cpu asks for the CPU, with the JAX script's flags. Reports
go to the checkout's chiprun_out/ or --out, never into reports/."""
