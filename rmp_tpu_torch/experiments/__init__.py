"""The port's training scripts, after the JAX package's experiments/:
`tune_gains` (gain tuning through a differentiable rollout),
`train_neural_rmp` (the learned reach attractor) and `train_neural_clutter`
(the learned obstacle leaf). Each runs as a module,
`python -m rmp_tpu_torch.experiments.<name> [--cpu] ...`, on the card
unless --cpu asks for the CPU, with the JAX script's flags."""
