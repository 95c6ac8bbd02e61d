"""The port's dataflow walker (``analysis.dataflow``) against the
reference's, on twin programs: each small program is written once in
``jnp`` and once in torch, and the reference's ``dataflow.analyze`` of its
jaxpr and the port's ``analyze`` of its recorded torch program must agree
on the class, the boundary census and the nondet sites (the programs of
the reference's ``tests/test_certify.py``). Then the census of every
certified streaming row must not change when the probe doubles its bars:
sites are program sites, not recorded ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_backtesting_exploration_tpu.analysis import (
    dataflow as ref_dataflow)
from distributed_backtesting_exploration_tpu_torch.analysis import (
    certify, dataflow)
from distributed_backtesting_exploration_tpu_torch.streaming import recurrent

# Non-integral float values so integrality must be proven, never
# accidental (the reference test's input).
_X = (np.linspace(0.1, 2.3, 8) + 0.017).astype(np.float32)
_F32 = torch.float32


def _ref(fn, *args, integral_inputs=None):
    return ref_dataflow.analyze(jax.make_jaxpr(fn)(*args),
                                integral_inputs=integral_inputs)


def _port(fn, *args, integral_inputs=None):
    return dataflow.analyze(dataflow.trace(fn, *args),
                            integral_inputs=integral_inputs)


# --- the twins --------------------------------------------------------------

def _jax_machine(z):
    def step(pos, z_t):
        ent = jnp.where(z_t < -1.0, jnp.float32(1.0),
                        jnp.where(z_t > 1.0, jnp.float32(-1.0),
                                  jnp.float32(0.0)))
        nxt = jnp.where(pos == 0, ent,
                        jnp.where((pos > 0) & (z_t >= 0.0),
                                  jnp.float32(0.0), pos))
        return nxt, nxt

    _, path = jax.lax.scan(step, jnp.zeros((), jnp.float32), z)
    return path


def _torch_machine(z):
    one = torch.ones((), dtype=_F32)
    zero = torch.zeros((), dtype=_F32)
    pos = zero
    path = []
    for t in range(z.shape[0]):
        z_t = z[t]
        ent = torch.where(z_t < -1.0, one,
                          torch.where(z_t > 1.0, -one, zero))
        pos = torch.where(pos == 0, ent,
                          torch.where((pos > 0) & (z_t >= 0.0), zero, pos))
        path.append(pos)
    return torch.stack(path)


def _jax_carry(x):
    c, _ = jax.lax.scan(lambda c, t: (c + t, c), jnp.zeros((), jnp.float32),
                        x)
    return c


def _torch_carry(x):
    c = torch.zeros((), dtype=_F32)
    for t in range(x.shape[0]):
        c = c + x[t]
    return c


def _jax_scatter(x):
    idx = jnp.array([0, 1, 1, 2, 3, 3, 0, 2])
    return jnp.zeros((4,), jnp.float32).at[idx].add(x)


def _torch_scatter(x):
    idx = torch.tensor([0, 1, 1, 2, 3, 3, 0, 2])
    return torch.zeros(4, dtype=_F32).index_add(0, idx, x)


def _jax_scatter_int(x):
    idx = jnp.array([0, 1, 1, 2])
    return jnp.zeros((4,), jnp.float32).at[idx].add(
        (x[:4] > 0).astype(jnp.float32))


def _torch_scatter_int(x):
    idx = torch.tensor([0, 1, 1, 2])
    return torch.zeros(4, dtype=_F32).scatter_add(
        0, idx, (x[:4] > 0).to(_F32))


def _jax_scatter_in_loop(x):
    def step(c, t):
        idx = jnp.array([0, 1, 1, 2])
        return c + jnp.zeros((4,), jnp.float32).at[idx].add(t), None

    return jax.lax.scan(step, jnp.zeros((4,), jnp.float32), x)[0]


def _torch_scatter_in_loop(x):
    idx = torch.tensor([0, 1, 1, 2])
    c = torch.zeros(4, dtype=_F32)
    for t in range(x.shape[0]):
        c = c + torch.zeros(4, dtype=_F32).index_add(
            0, idx, x[t].expand(4))
    return c


def _jax_turnover(p):
    prev = jnp.concatenate([jnp.zeros((1,), jnp.float32), p[:-1]])
    return jnp.sum(jnp.abs(p - prev))


def _torch_turnover(p):
    prev = torch.cat([torch.zeros(1, dtype=_F32), p[:-1]])
    return (p - prev).abs().sum()


def _jax_ladder_unrolled(x):
    x = x + jnp.concatenate([jnp.zeros((1,), x.dtype), x[:-1]])
    x = x + jnp.concatenate([jnp.zeros((2,), x.dtype), x[:-2]])
    x = x + jnp.concatenate([jnp.zeros((4,), x.dtype), x[:-4]])
    return x


def _torch_ladder_unrolled(x):
    x = x + torch.cat([torch.zeros(1, dtype=x.dtype), x[:-1]])
    x = x + torch.cat([torch.zeros(2, dtype=x.dtype), x[:-2]])
    x = x + torch.cat([torch.zeros(4, dtype=x.dtype), x[:-4]])
    return x


TWINS = {
    # The band/latch shape: selection, zero census, integral.
    "sign_select_machine": (_jax_machine, _torch_machine, None),
    # f32 sums of exact small ints: int-exact, zero census.
    "sum_of_bool_casts": (
        lambda x: jnp.sum((x > 0.5).astype(jnp.float32)),
        lambda x: (x > 0.5).to(_F32).sum(), None),
    # One reduce = one site; one cumsum = one site; two half-sums and
    # their merge add = three sites.
    "census_sum": (lambda x: jnp.sum(x * x), lambda x: (x * x).sum(),
                   None),
    "census_cumsum": (lambda x: jnp.cumsum(x)[-1],
                      lambda x: torch.cumsum(x, 0)[-1], None),
    "census_split_sum": (lambda x: jnp.sum(x[::2]) + jnp.sum(x[1::2]),
                         lambda x: x[::2].sum() + x[1::2].sum(), None),
    # The shift-doubling ladder written out, one add a pass: 3 sites.
    "cumsum_ladder": (_jax_ladder_unrolled, _torch_ladder_unrolled, None),
    # A float carry updated from itself: the merge add and the carry.
    "loop_carry": (_jax_carry, _torch_carry, None),
    "scatter_add": (_jax_scatter, _torch_scatter, None),
    "scatter_add_of_ints": (_jax_scatter_int, _torch_scatter_int, None),
    "scatter_add_in_a_loop": (_jax_scatter_in_loop, _torch_scatter_in_loop,
                              None),
    "nextafter_breaks_integrality": (
        lambda x: jnp.sum(jnp.nextafter(x, x + 1.0)),
        lambda x: torch.nextafter(x, x + 1.0).sum(), [True]),
    "comparison_launders_accumulation": (
        lambda x: jnp.where(jnp.sum(x) > 1.0, jnp.float32(1.0),
                            jnp.float32(0.0)),
        lambda x: torch.where(x.sum() > 1.0,
                              torch.tensor(1.0, dtype=_F32),
                              torch.tensor(0.0, dtype=_F32)), None),
    "elementwise_arithmetic_stays_exact": (
        lambda x: x * jnp.float32(2.0) - jnp.exp(-x),
        lambda x: x * 2.0 - torch.exp(-x), None),
    "integral_input_hint": (_jax_turnover, _torch_turnover, [True]),
    "no_integral_hint": (_jax_turnover, _torch_turnover, None),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_programs_agree_with_the_reference(name):
    jfn, tfn, hint = TWINS[name]
    ref = _ref(jfn, _X, integral_inputs=hint)
    port = _port(tfn, _X, integral_inputs=hint)
    assert len(ref.out_vals) == len(port.out_vals) == 1
    (r,), (p,) = ref.out_vals, port.out_vals
    assert p.class_name == r.class_name, (p.class_name, r.class_name)
    assert p.boundaries == r.boundaries, (sorted(p.sites), sorted(r.sites))
    assert p.integral == r.integral
    assert len(port.nondet_sites) == len(ref.nondet_sites)
    if r.class_name == "nondet":
        assert p.chain and "@" in p.chain[-1]
    assert not p.weak and p.dtype == "float32"


def test_loop_ladder_is_one_site_and_a_carry_at_any_length():
    """The ladder as a loop, one line for every pass: the reference counts
    its unrolled equations (log2 T sites); the port counts program sites,
    the add once and the line once as a carry, at any length. Both call it
    float-accum."""
    def jl(x):
        s = 1
        while s < x.shape[-1]:
            x = x + jnp.concatenate([jnp.zeros((s,), x.dtype), x[:-s]])
            s *= 2
        return x

    def tl(x):
        s = 1
        while s < x.shape[-1]:
            x = x + torch.cat([torch.zeros(s, dtype=x.dtype), x[:-s]])
            s *= 2
        return x

    for n in (8, 32):
        x = np.resize(_X, n)
        (r,) = _ref(jl, x).out_vals
        (p,) = _port(tl, x).out_vals
        assert r.class_name == p.class_name == "float-accum"
        assert r.boundaries == int(np.log2(n))
        assert p.boundaries == 2
        assert any(s.endswith("#carry") for s in p.sites)


def test_weak_output_has_a_chain_like_the_reference():
    (r,) = _ref(lambda x: jnp.where(x > 0, 1.0, 0.0), _X).out_vals
    (p,) = _port(lambda x: torch.where(x > 0, 1.0, 0.0), _X).out_vals
    assert r.weak and p.weak
    assert p.weak_chain and any("@" in f for f in p.weak_chain)
    assert "test_torch_dataflow.py" in p.weak_chain[0]
    assert torch.get_default_dtype() == torch.float32


def test_in_place_writes_are_seen_as_values():
    """A loop that fills a buffer in place (the band machine's shape) is
    functionalized: the buffer's value carries what was written."""
    def fill(z):
        out = torch.empty_like(z)
        acc = torch.zeros((), dtype=_F32)
        for t in range(z.shape[0]):
            acc = acc + z[t]
            out[t] = acc
        return out

    (p,) = _port(fill, _X).out_vals
    assert p.class_name == "float-accum"
    assert p.boundaries == 2


def test_host_round_trip_is_collected():
    an = _port(lambda x: x * float(x.sum().item()), _X)
    assert [op for op, _ in an.callbacks] == ["_local_scalar_dense"]
    assert "test_torch_dataflow.py" in an.callbacks[0][1]


# --- census independence of the probe's length -----------------------------

def _census(family, substrate, form, scale):
    fn, args, keys = recurrent.certify_probe(family, form=form,
                                             epilogue=substrate,
                                             scale=scale)
    row = certify.certify_callable("x", fn, args, keys)
    return {label: (o["class"], o["boundaries"])
            for label, o in row.outputs.items()}


@pytest.mark.parametrize("family", certify.stream_families())
def test_census_is_the_same_at_twice_the_probes_bars(family):
    for substrate in certify.SUBSTRATES:
        for form in certify.FORMS:
            one = _census(family, substrate, form, 1)
            two = _census(family, substrate, form, 2)
            assert one == two, (substrate, form, {
                k: (one[k], two.get(k)) for k in one if one[k] != two.get(k)})
