"""The port's optimizers."""

from .transforms import KronWhiten, kron_whiten

__all__ = ["KronWhiten", "kron_whiten"]
