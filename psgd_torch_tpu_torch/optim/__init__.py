"""The port's optimizers: the ``torch.optim.Optimizer`` counterparts of the
JAX transforms (``transforms``), of the legacy families
(``legacy_transforms``) and the reference's closure classes
(``classes``)."""

from .legacy_transforms import (SPLU, UVd, XMat, Affine, NewtonInv, affine,
                                newton_inv, splu, uvd, xmat)
from .transforms import (DenseNewton, KronNewton, KronWhiten, LRANewton,
                         LRAWhiten, dense_newton, kron_newton, kron_whiten,
                         lra_newton, lra_whiten)

__all__ = ["Affine", "DenseNewton", "KronNewton", "KronWhiten", "LRANewton",
           "LRAWhiten", "NewtonInv", "SPLU", "UVd", "XMat", "affine",
           "dense_newton", "kron_newton", "kron_whiten", "lra_newton",
           "lra_whiten", "newton_inv", "splu", "uvd", "xmat"]
