"""The port's optimizers: the ``torch.optim.Optimizer`` counterparts of the
JAX transforms (``transforms``) and the reference's closure classes
(``classes``)."""

from .transforms import (DenseNewton, KronNewton, KronWhiten, LRANewton,
                         LRAWhiten, dense_newton, kron_newton, kron_whiten,
                         lra_newton, lra_whiten)

__all__ = ["DenseNewton", "KronNewton", "KronWhiten", "LRANewton", "LRAWhiten",
           "dense_newton", "kron_newton", "kron_whiten", "lra_newton",
           "lra_whiten"]
