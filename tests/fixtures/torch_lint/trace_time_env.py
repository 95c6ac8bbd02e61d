"""Seeded violation for the port's ``trace-time-env``: an ``os.environ``
read reachable from a launch wrapper (a function that names a C entry
point ``dbx_*``), the ``DBX_LANES_CAP`` bug class at the launch boundary.
Never imported; the rule works on the AST alone."""

import os

import torch


def _lanes_from_env(lanes):
    # VIOLATION: read at the launch, after the public call resolved its
    # width — the launches of one call can split between two widths.
    env = os.environ.get("DBX_LANES_CAP")
    return int(env) if env else lanes


def _launch_fused(lib, x, out, lanes):
    lanes = _lanes_from_env(lanes)
    return lib.dbx_fused(x.data_ptr(), out.data_ptr(), lanes)


def _tile_from_env():
    # dbxlint: disable=trace-time-env -- suppressed twin of the above
    return int(os.environ.get("DBX_TILE", "0"))


def _launch_tiled(lib, x, out):
    return getattr(lib, f"dbx_{'tiled'}")(x.data_ptr(), out.data_ptr(),
                                          _tile_from_env())


def resolve_lanes_cap():
    # NOT a violation: the public call reads the knob once and passes the
    # width down (``ops.fused.resolve_lanes_cap`` is the template).
    return int(os.environ.get("DBX_LANES_CAP") or 0)


def fused_sweep(lib, x):
    out = torch.empty_like(x)
    _launch_fused(lib, x, out, resolve_lanes_cap() or 128)
    return out
