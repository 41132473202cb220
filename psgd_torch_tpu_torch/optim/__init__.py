"""The port's optimizers."""

from .transforms import KronNewton, KronWhiten, kron_newton, kron_whiten

__all__ = ["KronNewton", "KronWhiten", "kron_newton", "kron_whiten"]
