"""The port's entry points, each run as ``python -m
pdm_tpu_torch.scripts.<name>`` with the flags of the JAX package's
``scripts/<name>.py`` and ``--device`` (the card by default; ``cpu`` runs
the plain versions). They read and write the artifacts the JAX scripts
do, under the working directory: ``stats/``, ``checkpoints/``, ``logs/``,
``samples/`` and ``fid/``.

Pipeline: compute_stats_forward -> train_diffusion -> sample ->
compute_fid (train_lenet first for MNIST's FID; convert_inception_weights
for Inception's; convert_orbax_checkpoint to sample a JAX-trained model).
optimize_schedule optimizes a sampling schedule's knots through the
sampler (the analytic denoiser on the 1-D GMM) -> optimized_log_temp.npz.
export_sampler freezes the configured sampler's step into a serving
artifact (utils/serving.py).

The offline experiments, which need no dataset and no weights:
sample_gmm, verify_mc_metric, verify_logsnr_metric,
verify_rescaled_metric, analyze_synthetic_stats, reproduce_high_dim and
e2e_synthetic; compute_stats_empirical and compute_model_metric_schedule
run the model-based statistics of the configured (pretrained or
analytic) model. Their plots are written where matplotlib is installed.
"""
