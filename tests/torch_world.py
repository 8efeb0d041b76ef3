"""Worlds of gloo ranks on the CPU for the port's parallel tests, and the
bodies the ranks run.

A test builds its inputs with both packages in the pytest process, saves the
port's side (tensors, bridged param trees) to a file, and :func:`run_world`
starts ``size`` processes (``torch.multiprocessing``, spawn) that rendezvous
through a ``FileStore`` in the test's directory, load the file and run each
case's body in turn. Every rank returns its results, which the test compares
with the JAX package's. This module imports only torch, numpy and the port:
a spawned rank unpickles it, and must not import JAX. Every world has a
timeout, in its collectives and in the parent's join, so a hang fails its
test instead of running the suite out of time.

Every rank runs every case, members of the case's mesh or not (building a
mesh is collective over the whole world); a rank outside the mesh returns
None for it. A case that raises on a rank records the traceback as its
result there, so its test fails with it while the other cases still report.
"""

from __future__ import annotations

import datetime
import os
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD_TIMEOUT_S = 240
COLLECTIVE_TIMEOUT_S = 60


def run_world(size: int, cases: dict, workdir: Path, timeout: float = WORLD_TIMEOUT_S) -> list:
    """Run ``cases`` ({name: (body name, kwargs)}) on ``size`` gloo ranks;
    returns each rank's {name: result}."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(cases, workdir / "cases.pt")
    store = workdir / "store"
    store.unlink(missing_ok=True)
    ctx = mp.start_processes(_rank_main, args=(size, str(workdir)), nprocs=size, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world of {size} ranks still running after {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(size)]


def _rank_main(rank: int, size: int, workdir: str) -> None:
    torch.set_num_threads(1)
    workdir = Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'store'}", rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        cases = torch.load(workdir / "cases.pt", weights_only=False)
        results = {}
        for name, (body, kwargs) in cases.items():
            try:
                results[name] = BODIES[body](**kwargs)
            except Exception:  # reported to the case's test, not swallowed
                results[name] = {"error": traceback.format_exc()}
        torch.save(results, workdir / f"rank{rank}.pt.tmp")
        os.replace(workdir / f"rank{rank}.pt.tmp", workdir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def result(results: list, name: str, rank: int = 0):
    """A case's result on ``rank``; raises with the rank's traceback if it failed."""
    got = results[rank][name]
    if isinstance(got, dict) and "error" in got:
        raise AssertionError(f"rank {rank} failed case {name}:\n{got['error']}")
    return got


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


# -- bodies ---------------------------------------------------------------------


def tp_ops_body(tp: int, ops: dict):
    """Every tensor-parallel op of ``ops`` ({name: kwargs}) over a (1, tp) mesh."""
    from onnx_quantize_tpu_torch.parallel import collective, tp_ops
    from onnx_quantize_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(model_parallel=tp, ranks=list(range(tp)))
    if not mesh.coords:
        return None
    fns = {"column": tp_ops.column_parallel_matmul, "row": tp_ops.row_parallel_matmul,
           "pair": tp_ops.tp_pair_matmul, "allgather": collective.allgather_matmul,
           "reduce_scatter": collective.matmul_reduce_scatter,
           "sp_pair": collective.sequence_parallel_pair}
    out = {}
    for name, (fn, args, kw) in ops.items():
        if kw.pop("activation", None) == "gelu":
            kw["activation"] = lambda h: torch.nn.functional.gelu(h, approximate="tanh")
        out[name] = _np(fns[fn](*args, mesh, **kw))
    return out


def comm_body():
    """A (data 2, model 2) mesh and one call of each collective over it."""
    from onnx_quantize_tpu_torch.parallel import comm
    from onnx_quantize_tpu_torch.parallel.mesh import make_mesh, use_mesh

    mesh = make_mesh(model_parallel=2)
    comm.reset_stats()
    r = dist.get_rank()
    with use_mesh(mesh):
        x = torch.full((2, 3), float(r))
        out = {
            "shape": dict(mesh.shape), "coords": dict(mesh.coords), "backend": mesh.backend,
            "members": dict(mesh.members),
            "index": (comm.axis_index("data"), comm.axis_index("model")),
            "size": (comm.axis_size("data"), comm.axis_size("model")),
            "all_reduce": _np(comm.all_reduce(x, "model")),
            "all_gather": _np(comm.all_gather(x, "data", dim=1)),
            "all_to_all": _np(comm.all_to_all(torch.arange(2.0)[:, None] + 10 * r, "model")),
            "ring": _np(comm.ppermute(x, "model", [(0, 1), (1, 0)])),
            "one_way": _np(comm.ppermute(x, "data", [(0, 1)])),
        }
    out["stats"] = {**comm.stats, "ops": dict(comm.stats["ops"])}
    # The nccl check on ranks that report one device (every CPU rank says 0).
    current = torch.cuda.current_device
    torch.cuda.current_device = lambda: 0
    try:
        mesh._refuse_shared_devices()
        out["shared_device"] = None
    except ValueError as exc:
        out["shared_device"] = str(exc)
    finally:
        torch.cuda.current_device = current
    return out


def _model(cfg: dict):
    from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config

    return Gemma3(Gemma3Config(**cfg))


def engine_body(cfg: dict, params, dp: int, tp: int, ids, lengths, steps: int,
                max_seq: int = 32, kv_quant=True, prompts=None, max_new_tokens: int = 3,
                eos_from_first: bool = False, refusals: bool = False, device: str = "cpu",
                sample_seed: int | None = None):
    """The mesh engine's prefill, decode_multi and (with ``prompts``) serve
    rounds, as the JAX package's TP engine tests run them; ``dp = 0`` runs the
    single-device engine. With ``sample_seed``, the same again sampled at
    temperature 1 from a generator of that seed. On ``device="cuda"`` the
    rank's kernel launches are counted."""
    from onnx_quantize_tpu_torch.engine import (
        ContinuousBatchingScheduler,
        InferenceEngine,
        SamplingParams,
        sample,
    )
    from onnx_quantize_tpu_torch.ops.kernels import matmul_w4, matmul_w8
    from onnx_quantize_tpu_torch.parallel.mesh import make_mesh
    from onnx_quantize_tpu_torch.utils import tree_map

    model = _model(cfg)
    mesh = make_mesh(model_parallel=tp, ranks=list(range(dp * tp))) if dp else None
    if mesh is not None and not mesh.coords:
        return None
    if device != "cpu":
        params = tree_map(lambda t: t.to(device), params)
    launches = matmul_w4.launches, matmul_w8.launches
    B = ids.shape[0]
    engine = InferenceEngine(model, params, max_batch=B, max_seq=max_seq, kv_quant=kv_quant,
                             mesh=mesh)
    cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
    first = torch.argmax(logits, -1).to(torch.int32)
    cache, gen = engine.decode_multi(cache, first, steps=steps)
    out = {"logits": _np(logits), "first": _np(first), "gen": _np(gen),
           "lengths": _np(cache["lengths"]),
           "launches": (matmul_w4.launches - launches[0], matmul_w8.launches - launches[1])}
    if eos_from_first:
        eos = int(gen[0, 0])
        cache2, logits2 = engine.prefill(engine.new_cache(), ids, lengths)
        first2 = torch.argmax(logits2, -1).to(torch.int32)
        _, gen2 = engine.decode_multi(cache2, first2, steps=steps, eos_token_id=eos)
        out.update(eos=eos, gen_eos=_np(gen2), lengths_eos=_np(cache2["lengths"]))
    if prompts is not None:
        sched = ContinuousBatchingScheduler(engine, chunk=2, pipeline=2)
        reqs = [sched.submit(list(p), max_new_tokens=max_new_tokens) for p in prompts]
        sched.run()
        out["served"] = [r.output for r in reqs]
    if sample_seed is not None:
        sp = SamplingParams(temperature=1.0)
        gen_s = torch.Generator().manual_seed(sample_seed)
        cache, logits = engine.prefill(engine.new_cache(), ids, lengths)
        first = sample(logits, gen_s, sp)
        _, gen = engine.decode_multi(cache, first, steps=steps, sampling=sp, generator=gen_s)
        out["sampled"] = np.concatenate([_np(first)[:, None], _np(gen)], axis=1)
        sched = ContinuousBatchingScheduler(
            engine, generator=torch.Generator().manual_seed(sample_seed), chunk=2, pipeline=2)
        reqs = [sched.submit(list(p), max_new_tokens=max_new_tokens, sampling=sp)
                for p in prompts]
        sched.run()
        out["served_sampled"] = [r.output for r in reqs]
    if refusals:
        from onnx_quantize_tpu_torch.engine.speculative import SpeculativeDecoder

        refused = {}
        for what, call in (
                ("speculative", lambda: SpeculativeDecoder(engine, engine, k=2)),
                ("score_nll", lambda: engine.score_nll(_np(ids))),
                ("prefix", lambda: engine.prefill(engine.new_cache(), ids, lengths,
                                                  prefix={"k": ids})),
                ("narrow", lambda: engine.serve_chunk(
                    engine.new_cache(), np.zeros(B, np.int32), 1, eos=np.full(B, -1),
                    sampling_arrays=(np.zeros(B), np.zeros(B), np.ones(B)),
                    variant=(False, False, False), active=np.ones(B, bool),
                    budgets=np.full(B, 4), admit_ids=_np(ids)[:1],
                    admit_lengths=_np(lengths)[:1], admit_slots=np.zeros(1, np.int32)))):
            try:
                call()
                refused[what] = None
            except NotImplementedError as exc:
                refused[what] = str(exc)
        out["refused"] = refused
    return out


def a2a_body(ep: int, x, top_p, top_i, stacked, num_experts: int, activation: str,
             capacities: tuple):
    """``a2a_moe_mlp`` over an ``ep`` axis: rank r holds rows and experts of block r."""
    from onnx_quantize_tpu_torch.parallel.comm import axis_index
    from onnx_quantize_tpu_torch.parallel.ep import a2a_moe_mlp
    from onnx_quantize_tpu_torch.parallel.mesh import Mesh, P, use_mesh
    from onnx_quantize_tpu_torch.parallel.tp import shard_params_local

    mesh = Mesh(np.arange(ep), ("ep",))
    if not mesh.coords:
        return None

    def specs(tree):
        if isinstance(tree, dict):
            return {k: specs(v) for k, v in tree.items()}
        import dataclasses

        from onnx_quantize_tpu_torch.nn.qtensor import QTensor

        if isinstance(tree, QTensor):
            return dataclasses.replace(tree, **{
                f.name: None if getattr(tree, f.name) is None else P("ep")
                for f in dataclasses.fields(tree) if f.name != "meta"})
        return P("ep")

    local = shard_params_local(stacked, specs(stacked), mesh)
    with use_mesh(mesh):
        r = axis_index("ep")
        m = x.shape[0] // ep
        rows = slice(r * m, (r + 1) * m)
        return {cap: _np(a2a_moe_mlp(x[rows], local, top_p[rows], top_i[rows], axis="ep",
                                     num_experts=num_experts, activation=activation,
                                     capacity=cap))
                for cap in capacities}


def pp_body(cfg: dict, params, stages: int, ids, microbatches: int):
    from onnx_quantize_tpu_torch.parallel.pp import (
        make_pipeline_mesh,
        pipeline_stage_params,
        pp_logits,
    )

    model = _model(cfg)
    mesh = make_pipeline_mesh(stages)
    if not mesh.coords:
        return None
    stage_tree, shared = pipeline_stage_params(model, params, stages)
    return _np(pp_logits(model, stage_tree, shared, ids, mesh, microbatches=microbatches))


def cp_body(cfg: dict, params, shards: int, ids, runs: list, tp: int = 0):
    """``cp_logits`` for each (mode, layout) of ``runs``; with ``tp``,
    ``cp_tp_logits`` over a (shards, tp) mesh."""
    from onnx_quantize_tpu_torch.parallel import cp

    model = _model(cfg)
    mesh = cp.make_cp_tp_mesh(shards, tp) if tp else cp.make_cp_mesh(shards)
    if not mesh.coords:
        return None
    out = {}
    for mode, layout in runs:
        if tp:
            out[(mode, layout)] = _np(cp.cp_tp_logits(model, params, ids, mesh, mode=mode,
                                                      layout=layout))
        else:
            out[(mode, layout)] = _np(cp.cp_logits(model, params, ids, mesh, mode=mode,
                                                   layout=layout))
    return out


def perplexity_body(cfg: dict, params, shards: int, tokens, max_length: int, stride: int,
                    modes: tuple):
    from onnx_quantize_tpu_torch.parallel.cp import make_cp_mesh
    from onnx_quantize_tpu_torch.tools.perplexity import perplexity_from_tokens

    model = _model(cfg)
    mesh = make_cp_mesh(shards)
    if not mesh.coords:
        return None
    return {mode: perplexity_from_tokens(model, params, tokens, max_length, stride, mesh=mesh,
                                         cp_mode=mode) for mode in modes}


BODIES = {"comm": comm_body, "tp_ops": tp_ops_body, "engine": engine_body, "a2a": a2a_body, "pp": pp_body,
          "cp": cp_body, "perplexity": perplexity_body}
