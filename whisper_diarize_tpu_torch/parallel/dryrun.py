"""Multi-rank dry run of the port, the counterpart of the JAX package's
`__graft_entry__.py::dryrun_multichip`, and the helpers that spawn ranks.

    python -m whisper_diarize_tpu_torch.parallel.dryrun [N] [--cuda]

`dryrun_multigpu(n)` spawns n ranks (a mesh of (n / 2, 2) where n is even,
else (n, 1)), shards a small Whisper with the head-split rules and gives
each data rank its rows; every rank runs one AdamW training step (the loss
of the whole batch), then the serving path: mel -> encode -> greedy decode
over the int8 cross cache (K5 at the prompt pass) and a beam-3 decode (K4,
the un-fused tail over K1 under the head split). The ranks must agree on
the loss and on every token. On the CPU the ranks use gloo and the
kernels' plain versions; with `device_type="cuda"` they use NCCL where each
rank has a card of its own, else gloo over shared cards.

The model is the JAX dry run's (2 + 2 layers, vocab 51872) at 4 heads of
64 (d 256) instead of 2 (d 64): under a head split over 2 ranks each keeps
2 heads (one K2 tile of 128 columns), over 4 ranks one (K2's 64-column edge
tile).

Rank functions live at module level so that `torch.multiprocessing`'s spawn
and the tests can import them; `run_ranks` runs any of them.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue
import socket
import sys
import time
import traceback
from typing import Any, Callable, List, Optional

import numpy as np
import torch


def free_port() -> int:
    """A free TCP port on localhost (bind port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, backend: Optional[str], results,
               args) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if backend is None:  # the rank initializes itself, as under torchrun
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                              LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
        else:
            dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                    world_size=world, rank=rank,
                                    timeout=datetime.timedelta(seconds=120))
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *args, backend: Optional[str] = "gloo",
              timeout: float = 180.0) -> List[Any]:
    """Run fn(rank, world, *args) in `world` spawned processes that form one
    process group (localhost, a free port, one thread each) and return the
    ranks' results in rank order. `backend` None leaves the group to fn,
    with torchrun's environment set (MASTER_ADDR, MASTER_PORT, RANK,
    LOCAL_RANK, WORLD_SIZE). A rank that raises, or a run past `timeout`
    seconds (a hung collective), raises here; every process is stopped
    before this returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, backend, results, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks: {len(out)} done after {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and not errors:
                    raise RuntimeError(f"a rank died with exit code {dead[0]}")
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break  # the other ranks wait on it in a collective
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0) if not errors else 1.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(world)]


def dryrun_config():
    from ..models import whisper as wm

    return wm.WhisperConfig(
        n_mels=80, n_vocab=51872,  # divisible by 2 for the vocab split
        n_audio_ctx=1500, n_audio_state=256, n_audio_head=4, n_audio_layer=2,
        n_text_ctx=448, n_text_state=256, n_text_head=4, n_text_layer=2)


def dryrun_rank(rank: int, world: int, n_data: int, n_model: int,
                device_type: str = "cpu") -> dict:
    """One rank of `dryrun_multigpu`: its mesh, one TP + DP AdamW step, a
    greedy decode over the int8 cross cache and a beam-3 decode."""
    from .. import training
    from ..models import whisper as wm
    from ..ops import decode as dec
    from ..ops.mel import log_mel_spectrogram
    from ..tokenizer import DebugTokenizer
    from .distributed import global_mesh
    from .mesh import check_model_split, data_slice, replicate, shard_params

    device = torch.device("cpu")
    if device_type == "cuda":  # ranks beyond the cards share them
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = global_mesh(n_model, device_type)
    cfg = dryrun_config()
    check_model_split(cfg, n_model)
    params = shard_params(wm.init_params(cfg, seed=0, device=device), mesh)

    B, S = n_data, 8
    rows = data_slice(mesh, B)
    if mesh.shape != {"data": n_data, "model": n_model}:
        raise AssertionError(f"rank {rank}: mesh {mesh.shape}")
    if float(replicate(torch.full((1,), float(rank), device=device), mesh)) != 0.0:
        raise AssertionError(f"rank {rank}: replicate did not take rank 0's copy")
    mel = torch.zeros((B, cfg.n_mels, 3000), device=device)[rows]
    tokens = torch.arange(S, device=device).repeat(B, 1)[rows]
    mask = torch.ones((B, S - 1), device=device)[rows]
    optimizer = training.make_optimizer()
    opt_state = optimizer.init(params)
    step = training.make_train_step(cfg, optimizer, mesh)
    params, opt_state, loss = step(params, opt_state, mel, tokens, mask)
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    tk = DebugTokenizer(num_languages=cfg.num_languages)
    sp = tk.specials
    fns = _kernel_wrappers()
    before = [f.launches for f in fns.values()]
    with torch.inference_mode():
        audio = torch.zeros((B, 480000), device=device)[rows]
        xa = wm.encode(params, log_mel_spectrogram(audio, cfg.n_mels), cfg, mesh=mesh)
        prompt = torch.tensor([tk.sot_sequence(language="en")] * B, device=device)[rows]
        dc = dec.DecodeConfig(max_tokens=8, blank_id=32, mesh=mesh, quantize_cross_kv=True)
        res = dec.greedy_decode(params, cfg, dc, sp, xa, prompt, prompt.shape[1])
        dcb = dec.DecodeConfig(max_tokens=6, blank_id=32, beam_size=3, mesh=mesh)
        res_b = dec.beam_decode(params, cfg, dcb, sp, xa, prompt, prompt.shape[1])
    return {"mesh": mesh.shape, "loss": loss, "tokens": res.tokens.cpu().numpy(),
            "beam_tokens": res_b.tokens.cpu().numpy(),
            "launches": {k: f.launches - b for (k, f), b in zip(fns.items(), before)}}


def _kernel_wrappers() -> dict:
    """The wrappers of the kernels a mesh's decode runs, by kernel id (each
    wrapper's `launches` counts its bf16 and f32 forms)."""
    from ..ops import attn, tail

    return {"K1": attn.cross_attn_layer, "K2": attn.cross_kv_build,
            "K3": tail.fused_tail_layer, "K4": attn.split_self_attn_layer,
            "K5": attn.cross_attn_layer_q8}


# --------------------------------------------------------------------------
# Mesh jobs: what the multi-rank tests and `chip_smoke.py` run on each rank.
# Inputs are drawn from a seed with numpy (`job_inputs`), so the caller
# builds the same ones for its single-device reference.
# --------------------------------------------------------------------------

def job_inputs(cfg, B: int, seed: int, S: int = 8) -> dict:
    """The whole batch's inputs of the mesh jobs: mel [B, n_mels, 3000],
    audio states xa [B, 1500, d], training tokens [B, S] and a loss mask
    [B, S - 1] whose rows count 1 .. S - 1 targets (every rank a different
    count)."""
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, cfg.n_mels, 3000)).astype(np.float32)
    xa = rng.standard_normal((B, cfg.n_audio_ctx, cfg.n_text_state)).astype(np.float32)
    tokens = rng.integers(0, cfg.n_vocab, (B, S)).astype(np.int64)
    counts = (np.arange(B) * 5 + 1) % (S - 1) + 1
    mask = (np.arange(S - 1)[None, :] < counts[:, None]).astype(np.float32)
    return {"mel": mel, "xa": xa, "tokens": tokens, "mask": mask}


def gather_params(params: dict, mesh, prefix: str = "") -> dict:
    """The whole parameters as numpy, each sharded leaf all-gathered over
    the model group (every rank)."""
    from .mesh import all_gather, model_parallel, param_sharding_spec

    out = {}
    for k, v in params.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out[k] = gather_params(v, mesh, path)
            continue
        t = v.detach()
        dim = param_sharding_spec(path, t.ndim)
        if dim is not None and model_parallel(mesh):
            t = all_gather(t, mesh.model_group, dim=dim)
        out[k] = t.cpu().numpy()
    return out


def _job_encode(mesh, cfg, seed: int, B: int) -> np.ndarray:
    from ..models import whisper as wm
    from .mesh import data_slice, gather_data, shard_params

    params = shard_params(wm.init_params(cfg, seed=0, device=mesh.device), mesh)
    mel = torch.from_numpy(job_inputs(cfg, B, seed)["mel"][data_slice(mesh, B)])
    return gather_data(wm.encode(params, mel.to(mesh.device), cfg, mesh=mesh),
                       mesh).cpu().numpy()


def _job_decode(mesh, cfg, seed: int, B: int, strategy: str, max_tokens: int,
                beam_size: int = 3, quantize: bool = False, temperature: float = 0.0) -> dict:
    from ..models import whisper as wm
    from ..ops import decode as dec
    from ..tokenizer import DebugTokenizer
    from .mesh import data_slice, shard_params

    params = shard_params(wm.init_params(cfg, seed=3, device=mesh.device), mesh)
    tk = DebugTokenizer(num_languages=cfg.num_languages)
    rows = data_slice(mesh, B)
    xa = torch.from_numpy(job_inputs(cfg, B, seed)["xa"][rows]).to(mesh.device)
    prompt = torch.tensor([tk.sot_sequence(language="en")] * B, device=mesh.device)[rows]
    dc = dec.DecodeConfig(max_tokens=max_tokens, beam_size=beam_size, blank_id=32,
                          quantize_cross_kv=quantize, temperature=temperature, mesh=mesh)
    if strategy == "beam":
        res = dec.beam_decode(params, cfg, dc, tk.specials, xa, prompt, prompt.shape[1])
    elif strategy == "best_of":
        res = dec.sample_best_of(params, cfg, dc, tk.specials, xa, prompt, prompt.shape[1],
                                 best_of=beam_size)
    else:
        res = dec.greedy_decode(params, cfg, dc, tk.specials, xa, prompt, prompt.shape[1])
    return {k: getattr(res, k).cpu().numpy() for k in ("tokens", "lengths", "sum_logprob",
                                                        "avg_logprob")}


def _job_train(mesh, cfg, seed: int, B: int, steps: int = 1) -> dict:
    """`steps` AdamW steps of the whole batch from `job_inputs`: the loss of
    each step, the global gradient norm of the last, and (global rank 0)
    the updated parameters whole."""
    from .. import training
    from ..models import whisper as wm
    from .mesh import data_slice, shard_params

    params = shard_params(wm.init_params(cfg, seed=0, device=mesh.device), mesh)
    inp = job_inputs(cfg, B, seed)
    rows = data_slice(mesh, B)
    mel, tokens, mask = (torch.from_numpy(inp[k][rows]).to(mesh.device)
                         for k in ("mel", "tokens", "mask"))
    optimizer = training.make_optimizer()
    opt_state = optimizer.init(params)
    step = training.make_train_step(cfg, optimizer, mesh)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, mel, tokens, mask)
        losses.append(float(loss))
    norm = float(training.global_grad_norm(params, mesh))
    whole = gather_params(params, mesh)
    return {"losses": losses, "grad_norm": norm, "params": whole if mesh.rank == 0 else None}


def _job_collectives(mesh, cfg, n: int, rows: int, device: str = "cpu") -> dict:
    """`n` all-reduces over the model group, back to back, of the [rows,
    d] activation the head split reduces after each row-parallel product,
    on `device` (the rank's current CUDA device for "cuda"), timed by
    `timed_collectives` after one untimed call."""
    from .mesh import _all_reduce, timed_collectives

    x = torch.ones(rows, cfg.n_text_state, device=(
        torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else "cpu"))
    _all_reduce(x, mesh.model_group)
    with timed_collectives(x.device) as clock:
        for _ in range(n):
            _all_reduce(x, mesh.model_group)
    return dict(clock)


def _job_engine(mesh_shape, wavs, cache: str, greedy: bool, snapshot: str = None,
                use_gpu: bool = False, time_collectives: bool = False, **config) -> dict:
    """An Engine on `mesh_shape` (None: one device; on the card, device 0
    for every rank) serves `wavs` in one batch (English, no VAD). Returns
    the cues of each file as (start, end, text), every decode's tokens,
    lengths and log-probabilities, the request's wall seconds, the launches
    of K1 - K5 in this process (and K1's inside K3) and, with
    `time_collectives`, this rank's collectives in the request
    (`mesh.timed_collectives`)."""
    from ..engine import Engine, EngineConfig
    from ..ops import tail
    from ..types import AdvancedTranscribe, TranscribeOptions
    from .mesh import timed_collectives

    eng = Engine(EngineConfig(use_gpu=use_gpu, gpu_device=0 if use_gpu else None,
                              cache_dir=cache, whisper_model_path=snapshot,
                              vad_model_path="__random__",
                              mesh_shape=tuple(mesh_shape) if mesh_shape else None, **config))
    adv = AdvancedTranscribe(sampling_strategy="greedy") if greedy else None
    opts = TranscribeOptions(enable_vad=False, lang="en", advanced=adv)
    # the step the request will run, built first so that its decodes are
    # recorded on this instance
    step = eng._make_step(*eng._load_whisper(opts, None, None), opts)
    decodes, decode = [], step.decode

    def recorded(*a, **k):
        res = decode(*a, **k)
        decodes.append({f: getattr(res, f).cpu().numpy()
                        for f in ("tokens", "lengths", "sum_logprob", "avg_logprob")})
        return res

    step.decode = recorded
    fns = _kernel_wrappers()
    before = [f.launches for f in fns.values()]
    in_tail = tail.fused_tail_layer.cross_attn_launches
    with timed_collectives(eng.device) if time_collectives else contextlib.nullcontext() as clock:
        t0 = time.perf_counter()
        cue_lists = eng.transcribe_audio_batch(list(wavs), opts)
        if use_gpu:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: f.launches - b for (k, f), b in zip(fns.items(), before)}
    launches["K1 in K3"] = tail.fused_tail_layer.cross_attn_launches - in_tail
    return {"cues": [[(c.start, c.end, c.text) for c in cues] for cues in cue_lists],
            "decodes": decodes, "wall": wall, "launches": launches,
            "collectives": dict(clock) if clock else None}


def rank0_first_rank(rank: int, world: int, rendezvous_s: float, sleep_s: float,
                     cache: str) -> dict:
    """A rank that initializes from torchrun's environment with a
    `rendezvous_s` timeout, builds a CPU Engine on mesh (world, 1), and
    passes its rank-0-first block (downloads and conversions), where global
    rank 0 takes `sleep_s`; then one all-reduce of ones. Returns the
    seconds the block took on this rank and the sum."""
    import torch.distributed as dist

    from ..engine import Engine, EngineConfig
    from .distributed import initialize

    if not initialize(timeout_s=rendezvous_s):
        raise RuntimeError(f"rank {rank}: no process group")
    eng = Engine(EngineConfig(use_gpu=False, cache_dir=cache, batch_size=world,
                              mesh_shape=(world, 1)))
    t0 = time.perf_counter()
    with eng._rank0_first():
        if rank == 0:
            time.sleep(sleep_s)
    waited = time.perf_counter() - t0
    ones = torch.ones(1)
    dist.all_reduce(ones)
    return {"waited": waited, "sum": float(ones)}


JOBS = {"encode": _job_encode, "decode": _job_decode, "train": _job_train,
        "collectives": _job_collectives}


def mesh_rank(rank: int, world: int, jobs) -> dict:
    """Run `jobs`, a list of (name, kind, (n_data, n_model), kwargs), on this
    rank: kind "engine" gets its mesh shape and makes its own mesh, the
    others a CPU mesh of that shape (and `dryrun_config()` unless kwargs
    name a "cfg"). Returns {name: result}."""
    from .mesh import make_mesh

    meshes, out = {}, {}
    for name, kind, shape, kw in jobs:
        if kind == "engine":
            out[name] = _job_engine(shape, **kw)
            continue
        if tuple(shape) not in meshes:
            meshes[tuple(shape)] = make_mesh(*shape, device_type="cpu")
        kw = dict(kw)
        cfg = kw.pop("cfg", None) or dryrun_config()
        out[name] = JOBS[kind](meshes[tuple(shape)], cfg, **kw)
    return out


def dryrun_multigpu(n: int, device_type: str = "cpu", timeout: float = 180.0) -> dict:
    """Spawn n ranks and run `dryrun_rank` on a mesh of (n / 2, 2) (n even)
    or (n, 1); the ranks must agree bit for bit on the loss and the tokens.
    Returns rank 0's result."""
    n_model = 2 if n % 2 == 0 else 1
    n_data = n // n_model
    backend = ("nccl" if device_type == "cuda" and n <= torch.cuda.device_count()
               else "gloo")
    outs = run_ranks(dryrun_rank, n, n_data, n_model, device_type,
                     backend=backend, timeout=timeout)
    first = outs[0]
    for r, o in enumerate(outs[1:], start=1):
        if (o["loss"] != first["loss"] or not np.array_equal(o["tokens"], first["tokens"])
                or not np.array_equal(o["beam_tokens"], first["beam_tokens"])):
            raise AssertionError(f"rank {r} disagrees with rank 0: {o} vs {first}")
    if first["tokens"].shape[0] != n_data or first["beam_tokens"].shape[0] != n_data:
        raise AssertionError(f"expected {n_data} rows: {first}")
    print(f"dryrun_multigpu ok: mesh={first['mesh']} loss={first['loss']:.4f} "
          f"decode_tokens={first['tokens'].shape} beam_tokens={first['beam_tokens'].shape} "
          f"({backend}, {device_type})", flush=True)
    return first


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 2
    dryrun_multigpu(n, "cuda" if "--cuda" in sys.argv else "cpu")
