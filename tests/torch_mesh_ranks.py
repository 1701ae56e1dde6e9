"""Rank processes for the port's grid tests (``test_torch_mesh.py``,
``test_torch_mesh_gen.py``, ``test_torch_mesh_extra.py``,
``test_torch_multihost.py``, ``test_torch_cuda.py``).

:func:`run_ranks` starts ``world`` spawned processes that join one gloo
group on 127.0.0.1 at a free port, each with one thread, and runs a
function of this module in each (``parallel/multihost.run_ranks``, the
port's own runner); a rank writes what the test reads into
``out_dir``.  A rank that fails or outlives the timeout fails the call,
and every process still alive is killed.  This module imports torch and
the port only, so a rank starts without JAX.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

from eigenkernel_tpu_torch.parallel.multihost import free_port  # noqa: F401

TIMEOUT_S = 120


def run_ranks(fn_name: str, world: int, *args, backend: str = "gloo",
              timeout: float = TIMEOUT_S) -> None:
    """Run ``fn_name(rank, *args)``, a function of this module, on
    ``world`` ranks (``multihost.run_ranks``); raise unless every rank
    exits 0 within ``timeout`` seconds."""
    from eigenkernel_tpu_torch.parallel import multihost

    multihost.run_ranks(globals()[fn_name], world, *args, backend=backend,
                        timeout=timeout)


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def _grid(shape, device="cpu"):
    from eigenkernel_tpu_torch.parallel import mesh as pm

    return pm.make_mesh(tuple(shape), device)


def _whole(values, vectors, cols, grid):
    """(values, vectors) of a rank's column shares, whole, as numpy."""
    from eigenkernel_tpu_torch.parallel import mesh as pm

    k = values.shape[0]
    keep = cols < k
    v = pm.gather_slots(vectors[:, keep], (slice(None), cols[keep]),
                        (vectors.shape[0], k), grid)
    return values.cpu().numpy(), v.cpu().numpy()


@contextlib.contextmanager
def _env(values):
    """Set the environment variables ``values`` (a dict) for a block."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _Largest():
    """A dispatch mode that keeps the most elements of any new tensor an
    op made while it is on (``most``; off while ``paused``)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        most = 0
        paused = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            result = func(*args, **(kwargs or {}))
            if not self.paused:
                # new storage only: a view of an input is no allocation
                held = {t.untyped_storage().data_ptr() for t in
                        torch.utils._pytree.tree_leaves((args, kwargs))
                        if isinstance(t, torch.Tensor)}
                for t in torch.utils._pytree.tree_leaves(result):
                    if isinstance(t, torch.Tensor) and \
                            t.untyped_storage().data_ptr() not in held:
                        self.most = max(self.most, t.numel())
            return result

    return Largest()


def solve_cases(rank: int, shape, cases, out_dir: str,
                path: str = "") -> None:
    """Solve each (tag, solver, n_vec, dtype, a[, b[, env[, options]]])
    of ``cases`` on the grid (B, when given, a generalized problem;
    ``env`` the environment of the solve; ``options`` more keywords of
    ``solve``; dtype "mixed" hands the solve float64 blocks) and write
    the eigenpairs whole, with the verifier's numbers (residual average
    and max, orthogonality; B metric for a generalized problem) and the
    ipratios."""
    import torch

    from eigenkernel_tpu_torch.parallel import mesh as pm
    from eigenkernel_tpu_torch.solvers.api import solve
    from eigenkernel_tpu_torch.verify import (eval_orthogonality,
                                              eval_residual_norm,
                                              get_ipratios)

    grid = _grid(shape)
    out = {}
    for tag, solver, n_vec, dtype, a, *more in cases:
        b, env, options = (list(more) + [None, {}, {}][len(more):])[:3]
        dt = torch.float64 if dtype == "mixed" else getattr(torch, dtype)
        with _env(env):
            dm = pm.distribute(a, grid, dt)
            bm = None if b is None else pm.distribute(b, grid, dt)
            pairs = solve(dm, bm, solver=solver, n_vec=n_vec, mesh=grid,
                          dtype=dtype if dtype == "mixed" else None,
                          **options)
        w, v = _whole(pairs.values, pairs.vectors, pairs.cols, grid)
        k = w.shape[0]
        _, ave, mx = eval_residual_norm(dm, pairs, k, bm)
        out[f"{tag}/w"], out[f"{tag}/v"] = w, v
        out[f"{tag}/check"] = np.array([ave, mx,
                                        eval_orthogonality(pairs, 1, k, bm)])
        out[f"{tag}/ipr"] = get_ipratios(pairs, bm)
    np.savez(path or os.path.join(out_dir, f"rank{rank}.npz"), **out)


def generalized_modules(rank: int, shape, inputs: dict, out_dir: str) -> None:
    """The modules of the generalized and two-stage grid paths on their
    own, each result gathered whole: the products (``matmul`` plain and
    transposed, ``transpose``, ``times_tall``), the Cholesky factor, the
    inverse and the three solves, the three reductions' ``a_std`` and
    ``recover`` of the identity, ``to_band`` (the band's storage, Q
    applied to the identity, this rank's WY groups); and the largest
    tensor a rank made in a ``general_elpa2`` pipeline."""
    import torch

    from eigenkernel_tpu_torch.ops import band, blocked, reduction
    from eigenkernel_tpu_torch.parallel import mesh as pm

    grid = _grid(shape)
    f64 = torch.float64
    blk = int(inputs["block"])
    a = pm.distribute(inputs["a"], grid, f64)
    b = pm.fill_padding_diagonal(pm.distribute(inputs["b"], grid, f64), 1.0)
    c = pm.distribute(inputs["c"], grid, f64)
    n_m = a.n_m
    out = {"n_m": np.array(n_m)}
    lo, hi = pm.share(n_m, grid.size, grid.rank)
    eye = torch.eye(n_m, dtype=f64)[:, lo:hi]

    def whole_cols(z):
        return pm.gather_slots(z, (slice(None), slice(lo, hi)), (n_m, n_m),
                               grid).numpy()

    out["mm"] = pm.gather(pm.matmul(a, c, panel=blk)).numpy()
    out["mm_t"] = pm.gather(pm.matmul(a, c, trans_a=True, trans_b=True,
                                      panel=blk)).numpy()
    out["mm_part"] = pm.gather(pm.matmul(a, c, rows=(3, n_m - 5),
                                         cols=(7, n_m), inner=(2, n_m - 9),
                                         panel=blk)).numpy()
    out["c_t"] = pm.gather(pm.transpose(c)).numpy()
    x = torch.tensor(inputs["x"])
    out["tall"] = pm.times_tall(c, x[4:n_m - 1], (1, n_m - 2),
                                (4, n_m - 1)).numpy()
    l = blocked.blocked_cholesky(b, blk, grid)
    out["chol"] = pm.gather(l).numpy()
    out["inv"] = pm.gather(blocked.invert_lower_triangular(l, blk,
                                                           grid)).numpy()
    out["trsm"] = pm.gather(blocked.trsm_lower(l, a, block=blk,
                                               mesh=grid)).numpy()
    out["trsm_t"] = pm.gather(blocked.trsm_lower(l, a, transpose=True,
                                                 block=blk, mesh=grid)).numpy()
    out["trsm_r"] = pm.gather(blocked.trsm_right_lower_t(
        l, a, block=blk, mesh=grid)).numpy()
    for style, fn in (("scalapack", reduction.reduce_scalapack),
                      ("scalapack_new", reduction.reduce_scalapack_new),
                      ("elpa", reduction.reduce_elpa)):
        red = fn(a, b, grid, blk)
        out[f"{style}/a_std"] = pm.gather(red.a_std).numpy()
        out[f"{style}/recover"] = whole_cols(reduction.recover(red, eye, grid,
                                                               blk))
    try:
        blocked.blocked_cholesky(pm.distribute(-inputs["b"], grid, f64), blk,
                                 grid)
        out["breakdown"] = np.array("")
    except blocked.NotPositiveDefiniteError as exc:
        out["breakdown"] = np.array(str(exc))
    bw = int(inputs["bw"])
    res = band.to_band(a, bw, mesh=grid)
    out["band/lower"] = res.lower.numpy()
    out["band/taus"] = res.taus.numpy()
    out["band/Q"] = whole_cols(band.apply_band_q(res, eye, mesh=grid))
    out["band/groups"] = np.array(sorted(res.V.mine), dtype=np.int64)
    for method in ("blocked", "wf_pallas"):
        out[f"largest/{method}"] = np.array(
            _largest_in_pipeline(a, b, grid, blk, method))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def extra_cases(rank: int, shape, cases, out_dir: str, base: int,
                watch=()) -> None:
    """:func:`solve_cases` for the cores of slice 7d (``jacobi``, ``qdwh``,
    the mixed refinement), with the qdwh recursion's base at ``base``;
    also writes the sizes of the blocks the grid split (``<tag>/splits``,
    negative where a split was refused) and, for the tags in ``watch``,
    the most elements of any tensor the jacobi core or the grid
    refinement made on this rank (``<tag>/largest``; D2's plain version
    unwatched: its tensors are a rank's pair blocks, and watching its
    many small ops costs seconds), with the matrix dimension the jacobi
    core padded to (``<tag>/big``) or the columns the refinement was
    handed on this rank (``<tag>/width``)."""
    import functools

    from eigenkernel_tpu_torch.ops import jacobi, qdwh
    from eigenkernel_tpu_torch.solvers import api

    mode = _Largest()
    seen = {"splits": [], "big": 0, "width": 0}
    grid_split = qdwh._split_grid
    on_grid = qdwh.spectral_dc_on_grid
    jac, ref, pair = (jacobi.block_jacobi_on_grid, api.refine_on_grid,
                      jacobi.pair_eigh)

    def counting(x, *args):
        out = grid_split(x, *args)
        seen["splits"].append(x.n_m if out is not None else -x.n_m)
        return out

    def watched(fn):
        def call(a, v, *args, **kwargs):
            P = a.grid.size
            if fn is jac:
                b = max(1, min(v, a.n_m // (2 * P)))
                seen["big"] = -(-a.n_m // (2 * b * P)) * 2 * b * P
            else:
                seen["width"] = v.vectors.shape[1]
            with contextlib.ExitStack() as stack:
                if watching:
                    stack.enter_context(mode)
                return fn(a, v, *args, **kwargs)
        return call

    def unwatched(*args):
        mode.paused = True
        try:
            return pair(*args)
        finally:
            mode.paused = False

    qdwh._split_grid = counting
    qdwh.spectral_dc_on_grid = functools.partial(on_grid, base=base)
    jacobi.block_jacobi_on_grid = watched(jac)
    api.refine_on_grid = watched(ref)
    jacobi.pair_eigh = unwatched
    try:
        out = {}
        for case in cases:
            tag = case[0]
            watching = tag in watch
            seen.update(splits=[], big=0, width=0)
            mode.most = 0
            path = os.path.join(out_dir, f"case{rank}.npz")
            solve_cases(rank, shape, [case], out_dir, path)
            out.update(np.load(path))
            out[f"{tag}/splits"] = np.array(seen["splits"], dtype=np.int64)
            out[f"{tag}/largest"] = np.array(mode.most)
            out[f"{tag}/big"] = np.array(seen["big"])
            out[f"{tag}/width"] = np.array(seen["width"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        qdwh._split_grid = grid_split
        qdwh.spectral_dc_on_grid = on_grid
        jacobi.block_jacobi_on_grid, api.refine_on_grid = jac, ref
        jacobi.pair_eigh = pair


def _largest_in_pipeline(a, b, grid, gemm_block: int, method: str) -> int:
    """The most elements of any tensor the ops of one ``general_elpa2``
    pipeline under ``EK_BACKTRANSFORM=method`` made on this rank (torch's
    dispatcher sees each op's outputs), at a bandwidth of half the
    reductions' panel width, the chase left out: under ``wf_pallas`` its
    reflector store is (n, T, bw) on every rank, whole, with its
    group-major copies for B4 (under the blocked schedule a rank holds
    one sweep range of it; ``test_torch_chunked.py`` measures that)."""
    from eigenkernel_tpu_torch.ops import chase, wf_bt
    from eigenkernel_tpu_torch.solvers import pipelines as pl

    mode = _Largest()

    def unwatched(run):
        def call(*args, **kwargs):
            mode.paused = True
            try:
                return run(*args, **kwargs)
            finally:
                mode.paused = False
        return call

    ctx = pl.SolverContext(device=grid.device, block_size=gemm_block // 2,
                           mesh=grid, gemm_block=gemm_block)
    store = [(chase, "band_to_tridiag_chunked"), (wf_bt, "group_stores"),
             (wf_bt, "_composite_views")]
    runs = [getattr(mod, name) for mod, name in store]
    for (mod, name), run in zip(store, runs):
        setattr(mod, name, unwatched(run))
    try:
        with _env({"EK_BACKTRANSFORM": method}), mode:
            pl.generalized_pipeline(ctx, a, b, a.n,
                                    "two_stage", "elpa")
    finally:
        for (mod, name), run in zip(store, runs):
            setattr(mod, name, run)
    return mode.most


def module_checks(rank: int, shape, inputs: dict, out_dir: str) -> None:
    """The sharded modules on their own: ``tridiagonalize`` and
    ``apply_q`` (each (matrix, block) of ``inputs["tri"]``),
    ``tridiag_dc``, the selecting core (its eigenvalues and the first
    shifted solve's lanes recorded), ``distribute_coo`` and the grid's
    Gershgorin sentinel."""
    import torch

    from eigenkernel_tpu_torch.core.types import SparseMatrix
    from eigenkernel_tpu_torch.ops import dc, householder, tridiag
    from eigenkernel_tpu_torch.ops import tridiag_solve
    from eigenkernel_tpu_torch.ops.blocked import gershgorin_sentinel
    from eigenkernel_tpu_torch.parallel import mesh as pm

    grid = _grid(shape)
    f64 = torch.float64
    out = {}
    for c, (a, block) in enumerate(inputs["tri"]):
        tri = householder.tridiagonalize(pm.distribute(a, grid, f64), block,
                                         mesh=grid)
        for f in ("d", "e", "taus"):
            out[f"tri{c}/{f}"] = getattr(tri, f).numpy()
        # this rank's WY groups, in place in V; Q applied on the grid to
        # this rank's columns of the identity
        n = tri.d.shape[0]
        v_part = torch.zeros((n, n), dtype=f64)
        for i, blk in tri.V.mine.items():
            s, w = tri.V.groups[i]
            v_part[s:, s:s + w] = blk
        out[f"tri{c}/V_part"] = v_part.numpy()
        out[f"tri{c}/groups"] = np.array(sorted(tri.V.mine), dtype=np.int64)
        lo, hi = pm.share(n, grid.size, grid.rank)
        eye = torch.eye(n, dtype=f64)[:, lo:hi]
        q = householder.apply_q(tri, eye, block, mesh=grid)
        out[f"tri{c}/Q"] = _whole(tri.d, q, torch.arange(lo, hi), grid)[1]

    sharded = []
    merge = dc._merge_one

    def recording(*args, **kwargs):
        grid_arg = args[6] if len(args) > 6 else kwargs.get("grid")
        sharded.append(grid_arg is not None)
        return merge(*args, **kwargs)

    dc._merge_one = recording
    try:
        d = torch.tensor(inputs["dc_d"])
        e = torch.tensor(inputs["dc_e"])
        sh = dc.tridiag_dc(d, e, mesh=grid)
    finally:
        dc._merge_one = merge
    out["dc/w"], out["dc/v"] = _whole(*sh, grid)
    out["dc/sharded"] = np.array(sharded)

    first = []
    solve_fn = tridiag_solve.tridiag_solve

    def first_solve(*args):
        x = solve_fn(*args)
        if not first:
            first.append(x.clone())
        return x

    tridiag_solve.tridiag_solve = first_solve
    try:
        d = torch.tensor(inputs["sel_d"])
        e = torch.tensor(inputs["sel_e"])
        k = int(inputs["sel_k"])
        sh = tridiag.tridiag_eigh(d, e, k, mesh=grid)
    finally:
        tridiag_solve.tridiag_solve = solve_fn
    out["sel/lam"] = sh.values.numpy()
    out["sel/first"] = first[0].numpy() if first else np.zeros((d.shape[0],
                                                                0))
    out["sel/lanes"] = np.array(pm.share(k, grid.size, grid.rank))
    out["sel/w"], out["sel/v"] = _whole(*sh, grid)

    rows, cols, vals = inputs["coo"]
    coo = SparseMatrix(int(inputs["coo_n"]), rows, cols, vals)
    dm = pm.distribute_coo(coo, grid, f64)
    out["coo/block"] = dm.local.numpy()
    out["coo/at"] = np.array([dm.row0, dm.col0, dm.n_m])
    out["coo/sentinel"] = np.array(float(gershgorin_sentinel(dm, grid)))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def bcast_round_trip(rank: int, info, coo, out_dir: str) -> None:
    """Process 0 broadcasts ``info`` and ``coo`` (the others pass None),
    then a failed read and a failed probe; each rank writes what it got."""
    from eigenkernel_tpu_torch.core.types import SparseMatrix
    from eigenkernel_tpu_torch.parallel import multihost as mh

    master = mh.is_master()
    got = mh.bcast_matrix_info(info if master else None)
    sp = SparseMatrix(info.rows, *coo) if master else None
    sp = mh.bcast_coo(sp, got.rows, got.entries)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             info=np.array([got.rep, got.field, got.symm, got.rows, got.cols,
                            got.entries], dtype=object),
             rows=sp.rows, cols=sp.cols, values=sp.values, size=sp.size,
             ok=np.array([mh.bcast_ok(master), mh.bcast_ok(not master)]),
             failed=np.array(mh.bcast_matrix_info(None) is None))


def card_select(rank: int, shape, a, k: int, out_dir: str) -> None:
    """``scalapack_select -n k`` of ``a`` on a grid of ranks sharing card
    0 (gloo on CUDA tensors): the eigenpairs whole, the kernels' launches
    in the solve, and the selecting core's (d, e), eigenvalues and first
    shifted solve (made again after the counted run)."""
    import torch

    from eigenkernel_tpu_torch.ops import sturm, tridiag, tridiag_solve
    from eigenkernel_tpu_torch.parallel import mesh as pm
    from eigenkernel_tpu_torch.solvers.api import solve

    torch.cuda.set_device(0)
    grid = _grid(shape, torch.device("cuda", 0))
    seen = {}
    eigh_fn, solve_fn = tridiag.tridiag_eigh, tridiag_solve.tridiag_solve

    def record(store, fn):
        def call(*args, **kwargs):
            store.setdefault(fn.__name__, args)
            return fn(*args, **kwargs)
        return call

    tridiag.tridiag_eigh = record(seen, eigh_fn)
    tridiag_solve.tridiag_solve = record(seen, solve_fn)
    sturm.LAUNCHES = tridiag_solve.LAUNCHES = 0
    try:
        pairs = solve(a, solver="scalapack_select", n_vec=k, mesh=grid)
        torch.cuda.synchronize()
    finally:
        tridiag.tridiag_eigh = eigh_fn
        tridiag_solve.tridiag_solve = solve_fn
    launches = [sturm.LAUNCHES, tridiag_solve.LAUNCHES]
    w, v = _whole(pairs.values, pairs.vectors, pairs.cols, grid)
    d, e = seen["tridiag_eigh"][:2]
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), w=w, v=v,
             launches=np.array(launches), d=d.cpu().numpy(),
             e=e.cpu().numpy(),
             first=solve_fn(*seen["tridiag_solve"]).cpu().numpy(),
             lanes=np.array(pm.share(k, grid.size, grid.rank)))


def card_two_stage(rank: int, shape, a, b, out_dir: str) -> None:
    """``general_elpa2`` of (a, b), and ``eigensx`` of a under
    ``EK_BACKTRANSFORM=wf_pallas`` and ``pallas``, on a grid of ranks
    sharing card 0 (gloo on CUDA tensors): each solve's eigenvalues, its
    B3, B4 and B5 launches and the grid verifier's residual and
    orthogonality."""
    import torch

    from eigenkernel_tpu_torch.ops import backtransform, chase, wf_bt
    from eigenkernel_tpu_torch.parallel import mesh as pm
    from eigenkernel_tpu_torch.solvers.api import solve
    from eigenkernel_tpu_torch.verify import (eval_orthogonality,
                                              eval_residual_norm)

    torch.cuda.set_device(0)
    grid = _grid(shape, torch.device("cuda", 0))
    out = {}
    for tag, solver, bmat, bt in (("elpa2", "general_elpa2", b, "auto"),
                                  ("wf", "eigensx", None, "wf_pallas"),
                                  ("pallas", "eigensx", None, "pallas")):
        dm = pm.distribute(a, grid, torch.float64)
        bm = None if bmat is None else pm.distribute(bmat, grid,
                                                     torch.float64)
        chase.LAUNCHES = wf_bt.LAUNCHES = backtransform.LAUNCHES = 0
        with _env({"EK_BACKTRANSFORM": bt}):
            pairs = solve(dm, bm, solver=solver, mesh=grid)
        torch.cuda.synchronize()
        out[f"{tag}/launches"] = np.array([chase.LAUNCHES, wf_bt.LAUNCHES,
                                           backtransform.LAUNCHES])
        k = pairs.values.shape[0]
        out[f"{tag}/w"] = pairs.values.cpu().numpy()
        out[f"{tag}/check"] = np.array([
            eval_residual_norm(dm, pairs, k, bm)[2],
            eval_orthogonality(pairs, 1, k, bm)])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def chase_store_checks(rank: int, shape, lower, n: int, bw: int, group: int,
                       out_dir: str) -> None:
    """The grid's chase (``twostage.chase_on_grid``, blocked schedule) of
    the banded storage ``lower`` at ``EK_CHASE_CHUNKS`` = 4 and 1, with
    ``EK_BT_GROUP=group``: for each, the most elements of any tensor the
    chase made on this rank, the WY groups it kept, whether each kept
    slab equals that group's slab of one device's whole chase bit for
    bit, and d and e."""
    import torch

    from eigenkernel_tpu_torch.ops import bulge, chase
    from eigenkernel_tpu_torch.solvers import twostage

    grid = _grid(shape)
    lower = torch.tensor(lower)
    whole = chase.banded_to_tridiag(lower, n, bw)
    out = {}
    for chunks in (4, 1):
        mode = _Largest()
        with _env({"EK_CHASE_CHUNKS": str(chunks),
                   "EK_BT_GROUP": str(group)}), mode:
            res = twostage.chase_on_grid(lower, n, bw, grid, "blocked")
        st = res.HV
        same = [torch.equal(st.mine[G], torch.cat(
            [hv, ht[..., None]], dim=2)) for G in sorted(st.mine)
            for hv, ht in [bulge._group_slab(whole.HV, whole.HT, n, st.g,
                                             G)]]
        out[f"c{chunks}/most"] = np.array(mode.most)
        out[f"c{chunks}/groups"] = np.array(sorted(st.mine), dtype=np.int64)
        out[f"c{chunks}/n_groups"] = np.array(st.n_groups)
        out[f"c{chunks}/same"] = np.array(same)
        out[f"c{chunks}/de_equal"] = np.array(
            torch.equal(res.d, whole.d) and torch.equal(res.e, whole.e))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def sweep_on_grid(rank: int, shape, n: int, n_two: int, out_dir: str) -> None:
    """``entry.sweep_solvers_on_grid`` at float64 on the grid: every
    registry name's max residual."""
    from eigenkernel_tpu_torch import entry

    got = entry.sweep_solvers_on_grid(_grid(shape), n, np.float64, 1e-12,
                                      n_two)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             names=np.array(list(got)), resid=np.array(list(got.values())))
