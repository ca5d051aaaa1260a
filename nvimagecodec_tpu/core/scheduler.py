"""Batch orchestration: sort, split per codec, backend chain with fallback.

Counterpart of ImageGenericDecoder/ImageGenericEncoder +
DecoderWorker/EncoderWorker
(reference: src/image_generic_decoder.cpp:51-285 — sortSamples largest-first
:134-178, distributeWork :265-285; src/decoder_worker.cpp:29-307 — per-codec
worker with canDecode filter, fallback chain, runtime failure re-routing
:158-199; load_hint saturation per extensions/nvjpeg/hw_decoder.cpp:199,244).

Differences by design (device-first):
- Workers are tasks on a shared thread pool rather than one dedicated thread
  per (codec, priority) — the host side exists to feed the device, and batches
  are re-bucketed by shape downstream, so sub-batch tasks + futures give the
  same overlap with less thread churn.
- The backend ladder is TPU_ONLY/HYBRID_CPU_TPU → CPU_ONLY instead of
  HW_GPU → GPU → CPU.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .code_stream import CodeStream
from .interfaces import (
    DecodeParams,
    DecodeResult,
    DecoderPlugin,
    EncodeParams,
    EncodeResult,
    EncoderPlugin,
)
from .logger import (
    DebugMessageCategory,
    DebugMessageSeverity,
    emit,
    get_logger,
)
from .thread_pool import PriorityThreadPool
from .trace import span
from .promise import ProcessingResultsFuture, ProcessingResultsPromise
from .registry import CodecRegistry, global_registry
from .types import Backend, ChromaSubsampling, ProcessingStatus

log = get_logger(__name__)

_CSS_SORT_CLASS = {
    # Group samples so equal-subsampling images decode together, biggest first
    # (reference: sortSamples subsampling-class then area ordering,
    # src/image_generic_decoder.cpp:134-178).
    ChromaSubsampling.CSS_444: 0,
    ChromaSubsampling.CSS_440: 1,
    ChromaSubsampling.CSS_422: 2,
    ChromaSubsampling.CSS_420: 3,
    ChromaSubsampling.CSS_411: 4,
    ChromaSubsampling.CSS_410: 5,
    ChromaSubsampling.GRAY: 6,
    ChromaSubsampling.CSS_410V: 7,
    ChromaSubsampling.UNSUPPORTED: 8,
}


def _instantiate(cache, plugin, plugin_options, mesh=None):
    """Shallow-copy the registered prototype once per scheduler and apply
    this scheduler's options (and mesh, for device plugins) to the copy."""
    import copy

    key = id(plugin)
    inst = cache.get(key)
    if inst is None:
        inst = copy.copy(plugin)
        opts = plugin_options.get(inst.plugin_id)
        if opts:
            inst.set_options(opts)
        if mesh is not None:
            # device plugins shard their batched stage over the mesh
            inst.mesh = mesh
        cache[key] = inst
    return inst


def _allowed(plugin, backends: Optional[Sequence[Backend]]) -> bool:
    """Backend allowlist filter (reference: getDecoder skips disallowed
    backends, src/decoder_worker.cpp:63-93)."""
    if not backends:
        return True
    return any(b.kind == plugin.backend_kind for b in backends)


def _load_hint(plugin, backends: Optional[Sequence[Backend]]) -> float:
    if not backends:
        return 1.0
    for b in backends:
        if b.kind == plugin.backend_kind:
            return b.load_hint
    return 1.0


class GenericBatchProcessor:
    """Shared machinery for decode/encode orchestration."""

    def __init__(
        self,
        registry: Optional[CodecRegistry] = None,
        backends: Optional[Sequence[Backend]] = None,
        options: str = "",
        max_num_cpu_threads: int = 0,
        executor=None,
        mesh=None,
    ):
        """`executor`: optional user-supplied object with submit(fn, *args)
        returning a future — the analog of the reference's user executor
        vtable (src/user_executor.h); defaults to an internal thread pool
        (src/default_executor.cpp:25-77).

        `mesh`: optional jax.sharding.Mesh — device plugins shard their
        batched stage over it (images over "dp", J2K tiles/rows over "sp"),
        the communication layer the reference lacks (SURVEY.md §2.7)."""
        self.registry = registry or global_registry()
        self.backends = list(backends) if backends else None
        self.options = options
        self.mesh = mesh
        from .options import parse_options

        self.plugin_options = parse_options(options or "")
        # per-scheduler plugin instances: registered plugins are prototypes;
        # options must not leak across Decoder/Encoder objects (reference:
        # factories create one decoder instance per ImageDecoder,
        # src/image_decoder_factory.cpp)
        self._instance_cache: Dict[int, object] = {}
        import os

        n = max_num_cpu_threads or min(8, (os.cpu_count() or 2))
        # Per-device thread pool analog (reference: DefaultExecutor lazily
        # creates one ThreadPool per device, src/default_executor.cpp:25-77);
        # a user-supplied executor replaces it (src/user_executor.h). The
        # default pool drains a priority queue and honors TPUIMGCODEC_AFFINITY
        # (reference: priority work queue + affinity, src/thread_pool.cpp:84-196).
        self._pool = executor or PriorityThreadPool(
            max_workers=n, thread_name_prefix="imgcodec"
        )
        self._pool_is_priority = executor is None

    def _submit(self, fn, *args, priority: int = 0):
        """Submit honoring priority when the pool supports it; user executors
        only need plain submit() (reference: user_executor.h has no priority
        in its vtable either — schedule() takes task only)."""
        if self._pool_is_priority:
            return self._pool.submit(fn, *args, priority=priority)
        return self._pool.submit(fn, *args)


class GenericDecoder(GenericBatchProcessor):
    """Batch decode front-door (reference: ImageGenericDecoder,
    src/image_generic_decoder.cpp:181-198 decode / :265-285 distributeWork)."""

    def decode_batch_async(
        self,
        streams: Sequence[CodeStream],
        params: Optional[DecodeParams] = None,
    ) -> ProcessingResultsFuture[DecodeResult]:
        params = params or DecodeParams()
        n = len(streams)
        promise: ProcessingResultsPromise[DecodeResult] = ProcessingResultsPromise(n)
        # The entire front (parse, sort, split) runs on the pool so the caller
        # thread returns immediately with the future — the reference likewise
        # defers all work past the API call (src/image_generic_decoder.cpp:181-198
        # hands off to the worker; parse happened at CodeStream creation there,
        # here it is lazy so it must not run on the caller).
        self._submit(self._prepare_and_distribute, list(streams), params, promise,
                     priority=30)
        return promise.future()

    def _prepare_and_distribute(self, streams, params, promise,
                                inline: bool = False) -> None:
        # Parse all infos (parse errors fail just that sample).
        entries = []  # (orig_index, stream, info, codec_name)
        for i, cs in enumerate(streams):
            try:
                info = cs.get_image_info()
                entries.append((i, cs, info, cs.codec_name))
            except Exception as e:  # malformed stream
                promise.set(i, DecodeResult(ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED, error=str(e)))

        # Sort largest-first within subsampling class for bucketing efficiency
        # (reference: sortSamples NVTX range, src/image_generic_decoder.cpp:134-178).
        with span("imgcodec.sortSamples"):
            entries.sort(
                key=lambda e: (
                    _CSS_SORT_CLASS.get(e[2].chroma_subsampling, 9),
                    -(e[2].height * e[2].width),
                )
            )

        # Split per codec (reference: distributeWork, :265-285). Decode work
        # outranks encode (priority 10 vs 0) and the front-end (30) outranks
        # both so new batches keep the pipeline fed.
        per_codec: Dict[str, list] = {}
        for e in entries:
            per_codec.setdefault(e[3], []).append(e)

        for codec_name, group in per_codec.items():
            if inline:
                self._process_codec_group(codec_name, group, params, promise)
            else:
                self._submit(self._process_codec_group, codec_name, group,
                             params, promise, priority=10)

    # -- per-codec chain ----------------------------------------------------
    def _process_codec_group(self, codec_name, group, params, promise) -> None:
        try:
            codec = self.registry.codec(codec_name)
            chain = [
                _instantiate(self._instance_cache, d, self.plugin_options,
                             self.mesh)
                for d in codec.decoders
                if _allowed(d, self.backends)
            ]
            self._run_chain(chain, group, params, promise)
        except Exception as e:  # pragma: no cover - defensive
            log.exception("codec group %s failed", codec_name)
            for idx, _cs, _info, _name in group:
                try:
                    promise.set(idx, DecodeResult(ProcessingStatus.FAIL, error=str(e)))
                except RuntimeError:
                    pass

    def _run_chain(self, chain: List[DecoderPlugin], group, params, promise) -> None:
        """Try each backend in priority order; samples rejected by canDecode or
        failing at runtime fall through to the next backend
        (reference: src/decoder_worker.cpp:114-199,252-307)."""
        if not group:
            return
        if not chain:
            for idx, _cs, _info, _name in group:
                promise.set(
                    idx,
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.CODEC_UNSUPPORTED,
                        error="no decoder backend available",
                    ),
                )
            return

        decoder, rest = chain[0], chain[1:]
        data = [e[1].data for e in group]
        infos = [e[2] for e in group]
        try:
            statuses = decoder.can_decode(data, infos, params)
        except Exception as e:
            log.warning("canDecode of %s raised: %s", decoder.plugin_id, e)
            statuses = [ProcessingStatus.FAIL] * len(group)

        accepted = [e for e, s in zip(group, statuses) if s & ProcessingStatus.SUCCESS]
        rejected = [e for e, s in zip(group, statuses) if not (s & ProcessingStatus.SUCCESS)]

        # load_hint: backend takes only ceil(hint * batch) samples, the rest
        # are SATURATED onto the fallback (reference:
        # extensions/nvjpeg/hw_decoder.cpp:199,244).
        hint = _load_hint(decoder, self.backends)
        if hint < 1.0 and rest:
            import math

            take = math.ceil(hint * len(accepted))
            rejected = accepted[take:] + rejected
            accepted = accepted[:take]

        if rejected:
            self._run_chain(rest, rejected, params, promise)

        if accepted:
            adata = [e[1].data for e in accepted]
            ainfos = [e[2] for e in accepted]
            try:
                with span(f"imgcodec.decode.{decoder.plugin_id}"):
                    results = decoder.decode_batch(adata, ainfos, params)
            except Exception as e:
                log.warning("decode_batch of %s raised: %s", decoder.plugin_id, e)
                results = [DecodeResult(ProcessingStatus.FAIL, error=str(e))] * len(accepted)

            # Runtime fallback for per-sample failures
            # (reference: processCurrentResults, src/decoder_worker.cpp:158-199).
            failed = []
            for e, r in zip(accepted, results):
                if r.status & ProcessingStatus.SUCCESS:
                    promise.set(e[0], r)
                elif rest:
                    failed.append(e)
                else:
                    promise.set(e[0], r)
            if failed:
                # Fan the fallback event to registered debug messengers
                # (reference: decoder_worker.cpp:175 logs the fallback through
                # the debug-messenger chain).
                emit(
                    DebugMessageSeverity.WARNING,
                    DebugMessageCategory.PLUGIN,
                    f"{len(failed)} sample(s) failed in {decoder.plugin_id}; "
                    f"falling back to {rest[0].plugin_id}",
                    codec_id=decoder.plugin_id,
                )
                self._run_chain(rest, failed, params, promise)

    # -- sync convenience ---------------------------------------------------
    def decode_batch(
        self, streams: Sequence[CodeStream], params: Optional[DecodeParams] = None
    ) -> List[DecodeResult]:
        if len(streams) == 1 and self._pool_is_priority:
            # single-sample synchronous fast path: run the whole chain
            # inline on the caller thread — the two worker-thread hops +
            # condition-variable waits cost ~0.2 ms, dominating small
            # decodes (codec plugins still fan their own internal work
            # over the pool). A USER executor keeps the submit path:
            # routing work through it is its contract (user_executor.h).
            params = params or DecodeParams()
            promise: ProcessingResultsPromise[DecodeResult] = (
                ProcessingResultsPromise(1))
            self._prepare_and_distribute(list(streams), params, promise,
                                         inline=True)
            return promise.future().wait_all()
        return self.decode_batch_async(streams, params).wait_all()


class GenericEncoder(GenericBatchProcessor):
    """Batch encode front-door (reference: ImageGenericEncoder,
    src/image_generic_encoder.cpp:127-230; encode does not sort samples,
    :138)."""

    def encode_batch_async(
        self,
        arrays: Sequence[object],
        infos: Sequence[object],
        codec_name: str,
        params: Optional[EncodeParams] = None,
    ) -> ProcessingResultsFuture[EncodeResult]:
        params = params or EncodeParams()
        n = len(arrays)
        promise: ProcessingResultsPromise[EncodeResult] = ProcessingResultsPromise(n)
        group = list(zip(range(n), arrays, infos))
        self._submit(self._process_group, codec_name, group, params, promise,
                     priority=0)
        return promise.future()

    def _process_group(self, codec_name, group, params, promise) -> None:
        try:
            codec = self.registry.codec(codec_name)
            chain = [
                _instantiate(self._instance_cache, e, self.plugin_options,
                             self.mesh)
                for e in codec.encoders
                if _allowed(e, self.backends)
            ]
            self._run_chain(chain, group, params, promise)
        except Exception as e:  # pragma: no cover - defensive
            log.exception("encode group %s failed", codec_name)
            for idx, _a, _i in group:
                try:
                    promise.set(idx, EncodeResult(ProcessingStatus.FAIL, error=str(e)))
                except RuntimeError:
                    pass

    def _run_chain(self, chain: List[EncoderPlugin], group, params, promise) -> None:
        if not group:
            return
        if not chain:
            for idx, _a, _i in group:
                promise.set(
                    idx,
                    EncodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.CODEC_UNSUPPORTED,
                        error="no encoder backend available",
                    ),
                )
            return
        encoder, rest = chain[0], chain[1:]
        arrays = [e[1] for e in group]
        infos = [e[2] for e in group]
        try:
            statuses = encoder.can_encode(arrays, infos, params)
        except Exception as e:
            log.warning("canEncode of %s raised: %s", encoder.plugin_id, e)
            statuses = [ProcessingStatus.FAIL] * len(group)

        accepted = [e for e, s in zip(group, statuses) if s & ProcessingStatus.SUCCESS]
        rejected = [e for e, s in zip(group, statuses) if not (s & ProcessingStatus.SUCCESS)]
        if rejected:
            self._run_chain(rest, rejected, params, promise)
        if accepted:
            try:
                with span(f"imgcodec.encode.{encoder.plugin_id}"):
                    results = encoder.encode_batch(
                        [e[1] for e in accepted], [e[2] for e in accepted], params
                    )
            except Exception as e:
                log.warning("encode_batch of %s raised: %s", encoder.plugin_id, e)
                results = [EncodeResult(ProcessingStatus.FAIL, error=str(e))] * len(accepted)
            failed = []
            for e, r in zip(accepted, results):
                if r.status & ProcessingStatus.SUCCESS:
                    promise.set(e[0], r)
                elif rest:
                    failed.append(e)
                else:
                    promise.set(e[0], r)
            if failed:
                self._run_chain(rest, failed, params, promise)

    def encode_batch(self, arrays, infos, codec_name, params=None) -> List[EncodeResult]:
        if len(arrays) == 1 and self._pool_is_priority:
            # single-sample synchronous fast path (see GenericDecoder)
            params = params or EncodeParams()
            promise: ProcessingResultsPromise[EncodeResult] = (
                ProcessingResultsPromise(1))
            self._process_group(codec_name,
                                list(zip(range(1), arrays, infos)),
                                params, promise)
            return promise.future().wait_all()
        return self.encode_batch_async(arrays, infos, codec_name, params).wait_all()
