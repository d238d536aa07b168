"""Methods of the JAX package that the port has not reached yet.

Each becomes a method that raises ``NotImplementedError`` naming
``ROADMAP.md``, so the port's classes keep the reference's surface and
say what waits, instead of raising ``AttributeError``.
"""

from __future__ import annotations

__all__ = ["mark_not_ported", "not_ported_error"]


def not_ported_error(cls_name: str, name: str,
                     form: str = "") -> NotImplementedError:
    """The error a method that waits raises; ``form`` names the one
    form of it that waits, where the others are ported."""
    form = f" {form}" if form else ""
    return NotImplementedError(
        f"{cls_name}.{name} is not ported yet{form}; it waits for its own "
        f"slice of the port (see ROADMAP.md)")


def _not_ported(cls_name: str, name: str):
    def method(*args, **kwargs):
        raise not_ported_error(cls_name, name)
    method.__name__ = name
    method.__doc__ = ("Not ported yet: raises NotImplementedError "
                      "(see ROADMAP.md).")
    return method


def mark_not_ported(cls, names, classmethods=()) -> None:
    """Give ``cls`` a raising method for each of ``names`` and a raising
    classmethod for each of ``classmethods``."""
    for name in names:
        setattr(cls, name, _not_ported(cls.__name__, name))
    for name in classmethods:
        setattr(cls, name, classmethod(_not_ported(cls.__name__, name)))
