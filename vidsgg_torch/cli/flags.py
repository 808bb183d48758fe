"""Small helpers for the CLIs' pre-config flag scan (the port's own copy of
``vidsgg/cli/flags.py``, plus the refusal of flags not ported yet).

The train/test CLIs peel a few runner-level flags (``--synthetic``,
``--ckpt``, ``--profile``, ...) off argv before handing the rest to the
config parsers (which mirror the reference's flag surface). This guards the
two failure modes of the raw ``argv[i + 1]`` scan: the flag appearing last
(IndexError) and the value being omitted so the next flag is silently
swallowed.
"""

from __future__ import annotations

import sys


def take_flag(argv: list, flag: str, cast=str, default=None):
    """Remove ``flag VALUE`` from ``argv`` (in place) and return cast(VALUE);
    ``default`` when the flag is absent. Exits with a usage message when the
    value is missing or looks like another ``--flag``."""
    if flag not in argv:
        return default
    i = argv.index(flag)
    if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
        sys.exit(f"usage: {flag} requires a value")
    try:
        val = cast(argv[i + 1])
    except ValueError:
        sys.exit(f"usage: {flag} got invalid value {argv[i + 1]!r}")
    del argv[i : i + 2]
    return val


def take_switch(argv: list, flag: str) -> bool:
    """Remove a boolean switch from ``argv`` (in place); True if present."""
    if flag in argv:
        argv.remove(flag)
        return True
    return False


def refuse_unported(prog: str, unported):
    """Exit with a one-line message for the first (given, flag, item) the
    port cannot honour yet, rather than ignore it."""
    for given, flag, item in unported:
        if given:
            sys.exit(f"{prog}: {flag} is not ported to vidsgg_torch yet: {item}")
