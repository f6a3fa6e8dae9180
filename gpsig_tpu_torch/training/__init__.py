"""Training: natural gradients on q(u) alternating with Adam on the
hyperparameters (counterpart of ``gpsig_tpu.training``)."""
