"""Paged serving layer of the port.

:class:`ServingEngine` packs :class:`Request` objects into fixed decode
slots, admits same-bucket bursts in one prefill call into a
:class:`BlockPool` of fixed-size KV blocks (with copy-on-write prefix
sharing and a prefix cache) and advances every slot in one step per tick
that reads KV through the block tables with the paged decode kernel.
:class:`CompileCache` shares the engine's programs across engines keyed
on ``(cfg, opts, slots, max_seq, compile_domain)``."""
from .compile_cache import (CompileCache, GLOBAL_COMPILE_CACHE,
                            ServePrograms)
from .engine import DECODE_MODES, Request, ServeStats, ServingEngine
from .paging import (DEFAULT_BLOCK_SIZE, BlockPool, PrefixCache,
                     PrefixEntry, block_hash_chain, blocks_needed)
from .sampling import DEFAULT_SAMPLING, SamplingOpts, request_key

__all__ = ["CompileCache", "GLOBAL_COMPILE_CACHE", "ServePrograms",
           "Request", "ServeStats", "ServingEngine", "DECODE_MODES",
           "SamplingOpts", "DEFAULT_SAMPLING", "request_key",
           "DEFAULT_BLOCK_SIZE", "BlockPool", "PrefixCache", "PrefixEntry",
           "block_hash_chain", "blocks_needed"]
