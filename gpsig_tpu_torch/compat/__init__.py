"""GPSig-compatible API surface over the PyTorch port.

Counterpart of ``gpsig_tpu/compat/``, module for module: the reference's
(``maudl3116/GPSig``, GPflow 1.x) ``gpsig.kernels``,
``gpsig.inducing_variables``, ``gpsig.models``, GPflow's ``likelihoods``
and optimizers, and ``gpsig.preprocessing``, with flattened ``[N, L*d]``
inputs, numpy-in/numpy-out ``compute_*`` methods and a data-holding
``SVGP``. A GPSig script switches with::

    from gpsig_tpu_torch import compat as gpsig

    kern = gpsig.kernels.SignatureRBF(input_dim=L * d, num_features=d,
                                      num_levels=4)
    feat = gpsig.inducing_variables.InducingTensors(Z, num_levels=4,
                                                    increments=True)
    model = gpsig.models.SVGP(X, Y, kern,
                              gpsig.likelihoods.MultiClass(C), feat=feat,
                              num_latent=C, minibatch_size=50)
    gpsig.training.AdamOptimizer(1e-3).minimize(model, maxiter=500)
    mean, var = model.predict_y(X_test)

Every constructor that creates tensors takes ``dtype=`` (default
``torch.float64``) and ``device=`` (default the CUDA card,
``config.default_device()``); on a machine without a card pass
``device="cpu"``. The wrappers hold the port's ``nn.Module``s
(``to_functional()`` hands them back), and training updates those modules
in place.
"""

from gpsig_tpu_torch.compat import (  # noqa: F401
    inducing_variables,
    kernels,
    likelihoods,
    models,
    preprocessing,
    training,
)
