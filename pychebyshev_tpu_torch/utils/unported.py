"""The error of a form of the JAX package's surface that the port has
not reached yet: ``mesh=`` (multi-device), which raises
``NotImplementedError`` naming ``ROADMAP.md`` instead of running on one
device."""

from __future__ import annotations

__all__ = ["not_ported_error"]


def not_ported_error(cls_name: str, name: str,
                     form: str = "") -> NotImplementedError:
    """The error a method that waits raises; ``form`` names the one
    form of it that waits, where the others are ported."""
    form = f" {form}" if form else ""
    return NotImplementedError(
        f"{cls_name}.{name} is not ported yet{form}; it waits for its own "
        f"slice of the port (see ROADMAP.md)")
