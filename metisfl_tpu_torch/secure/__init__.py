"""Secure aggregation backends (the port's copy of the JAX package's
``secure/__init__.py``):

- ``identity``: no-op "encryption" for tests and plumbing checks;
- ``masking``: pairwise additive masking (Bonawitz et al.): learner sums
  cancel, the controller sees only masked blobs;
- ``ckks``: CKKS homomorphic encryption over the port's build of
  ``native/ckks.cc``.

Every backend is host numpy: the secure planes never touch the card.
Client-level differential privacy (``secure/dp.py``) clips and noises a
learner's update before any of them encrypts it.
"""

from metisfl_tpu_torch.secure.identity import IdentityBackend
from metisfl_tpu_torch.secure.masking import MaskingBackend


def make_backend(config, role: str = "learner", **kwargs):
    """A backend from a ``SecureAggConfig``. ``role`` is 'controller' or
    'learner': the controller never receives decryption capability for
    schemes that separate them."""
    scheme = config.scheme.lower()
    if scheme == "identity":
        return IdentityBackend()
    if scheme == "masking":
        return MaskingBackend(**kwargs)
    if scheme == "ckks":
        from metisfl_tpu_torch.secure.ckks import CKKSBackend
        return CKKSBackend(key_dir=config.key_dir, role=role, **kwargs)
    raise ValueError(f"unknown secure scheme {config.scheme!r}")


__all__ = ["IdentityBackend", "MaskingBackend", "make_backend"]
