"""tnqs_torch host plan against tnqs: graphs, edge coloring, the engine's
LatticePlan tables, compile_circuit and build_program must be identical."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tnqs
from tnqs import engine as jengine
from tnqs import models as jmodels

import tnqs_torch as tt
from tnqs_torch import engine as pengine

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

GRAPHS = {
    "eagle": tnqs.eagle_lattice,
    "hh22": lambda: tnqs.heavy_hexagonal_lattice(2, 2),
}
COLOR_GRAPHS = dict(
    GRAPHS,
    grid34=lambda: tnqs.named_grid((3, 4)),  # axis/parity coloring
    ring5=lambda: tnqs.named_ring_graph(5),  # odd cycle: Misra–Gries
)


def _port(g):
    return tt.NamedGraph.from_edges(g.vertices(), g.edges())


def test_eagle_lattice_matches():
    g, p = tnqs.eagle_lattice(), tt.eagle_lattice()
    assert p.vertices() == g.vertices()
    assert p.edges() == g.edges()
    assert all(p.neighbors(v) == g.neighbors(v) for v in g.vertices())


@pytest.mark.parametrize("name", list(COLOR_GRAPHS))
def test_center_and_edge_color_match(name):
    g = COLOR_GRAPHS[name]()
    p = _port(g)
    assert tt.center(p) == tnqs.center(g)
    assert tt.edge_color(p) == tnqs.edge_color(g)


@pytest.mark.parametrize("schedule", ["wavefront", "color"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_lattice_plan_matches(name, schedule):
    g = GRAPHS[name]()
    jp = jengine.LatticePlan.build(g, bp_schedule=schedule)
    pp = pengine.LatticePlan.build(_port(g), bp_schedule=schedule)
    assert pp.vertices == jp.vertices
    assert pp.neighbor_order == jp.neighbor_order
    assert pp.buckets == jp.buckets
    assert pp.bucket_pos == jp.bucket_pos
    assert pp.edge_ids == jp.edge_ids
    assert len(pp.bp_groups) == len(jp.bp_groups)
    for a, b in zip(pp.bp_groups, jp.bp_groups):
        assert a[:3] == b[:3] and a[6] == b[6]
        for x, y in zip(a[3:6], b[3:6]):
            np.testing.assert_array_equal(x, y)


def _layers(g, p):
    """The same circuits built by both packages."""
    return [
        (jmodels.heavy_hex_kicked_ising_layer(g, np.pi / 4, 0.4), tt.heavy_hex_kicked_ising_layer(p, np.pi / 4, 0.4)),
        (jmodels.tfim_layer(g, 1.0, 0.7, 0.05, hz=0.3), tt.tfim_layer(p, 1.0, 0.7, 0.05, hz=0.3)),
    ]


@pytest.mark.parametrize("name", list(GRAPHS))
def test_compile_circuit_and_program_match(name):
    g = GRAPHS[name]()
    p = _port(g)
    jp = jengine.LatticePlan.build(g, bp_schedule="color")
    pp = pengine.LatticePlan.build(p, bp_schedule="color")
    for jl, pl in _layers(g, p):
        assert [(n, list(v), t) for n, v, t in pl] == [(n, list(v), t) for n, v, t in jl]
        jc = jengine.compile_circuit(jp, jl)
        pc = pengine.compile_circuit(pp, pl)
        assert len(pc) == len(jc)
        for a, b in zip(pc, jc):
            assert type(a).__name__ == type(b).__name__
            if isinstance(a, pengine.OneSiteGroup):
                assert a.per_bucket.keys() == b.per_bucket.keys()
                for k in a.per_bucket:
                    for x, y in zip(a.per_bucket[k], b.per_bucket[k]):
                        np.testing.assert_array_equal(x, y)
            else:
                assert len(a.classes) == len(b.classes)
                for ca, cb in zip(a.classes, b.classes):
                    assert (ca.ku, ca.kv) == (cb.ku, cb.kv)
                    for field in ("u_pos", "v_pos", "slot_u", "slot_v", "env_u_eids", "env_v_eids",
                                  "eid_uv", "eid_vu", "gates", "gate_index"):
                        np.testing.assert_array_equal(getattr(ca, field), getattr(cb, field))
        jprog = [(e[0], e[2] if len(e) > 2 else None) for e in jengine.build_program(jp, jc)]
        pprog = [(e[0], e[2] if len(e) > 2 else None) for e in pengine.build_program(pp, pc)]
        assert pprog == jprog


def test_import_pulls_no_jax_or_networkx():
    """The port (its checkpoints, every flex-tier module, the full update,
    truncation, the variational search, the profiling hooks and the
    multi-device modules included) loads none of jax, optax, networkx or the
    JAX package, and adds no
    opt_einsum of its own: torch imports opt_einsum where it is installed,
    and the card's machine has none."""
    flex = ("core", "core.index", "core.tensor", "core.linalg", "sitetypes", "contraction", "networks", "forms",
            "bp", "gauging", "apply", "measure", "boundarymps", "sampling", "loopcorrections", "gates", "graphs",
            "fullupdate", "truncate", "variational", "utils.profiling", "parallel", "parallel.mesh",
            "parallel.halo", "parallel.halo_step", "parallel.pool", "parallel.dryrun")
    code = ("import sys, torch; before = set(sys.modules); import tnqs_torch, tnqs_torch.bmps_engine, tnqs_torch.checkpoint; "
            + "".join(f"import tnqs_torch.{m}; " for m in flex) +
            "tnqs_torch.BMPSSampler; tnqs_torch.load_engine; tnqs_torch.save_state; tnqs_torch.sample_certified; "
            "new = {m.split('.')[0] for m in set(sys.modules) - before}; "
            "loaded = [m for m in ('jax', 'optax', 'networkx', 'tnqs') if m in sys.modules] + sorted(new & {'opt_einsum'}); "
            "assert not loaded, loaded")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def _exported_names(path: pathlib.Path) -> set:
    """Public names a package's `__init__.py` binds at its top level: its
    relative imports and its assignments (the aliases)."""
    import ast

    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level >= 1:
            out |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in out if not n.startswith("_")}


def test_exports_match_the_jax_package():
    """Every name `tnqs/__init__.py` exports is exported by the port, and
    bound at import (`sharded_bp_energy_fn` too, since the port of
    `tnqs/parallel/`)."""
    jax_names = _exported_names(ROOT / "tnqs" / "__init__.py")
    port_names = _exported_names(ROOT / "tnqs_torch" / "__init__.py")
    assert "sharded_bp_energy_fn" in jax_names
    assert jax_names - port_names == set()
    assert {n for n in jax_names if not hasattr(tt, n)} == set()
