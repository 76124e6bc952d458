"""Two-stage pipeline parallelism: encoder stage / decoder stage.

The reference has no pipeline parallelism (single CPU; SURVEY §2.2
lists it absent). For an accelerator build it is the natural second axis
after TP when a model family grows: the encoder runs on one device
group and the greedy-decode loop on another, with JAX's async
dispatch overlapping batch i's encode with batch i-1's decode —
continuous batching keeps both stages busy.

For the tiny student models this is a capability demonstration (one
chip is far from saturated); the stage split and the overlap pattern
are what transfer to larger models.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from slimt_jax import device
from slimt_jax.models import transformer as tfm
from slimt_jax.models.decode import GreedyResult, greedy_decode


class TwoStagePipeline:
    def __init__(
        self,
        params: dict,
        num_heads: int,
        encoder_device,
        decoder_device,
        provider: Optional[str] = None,
    ):
        self.num_heads = num_heads
        self.provider = provider
        self.encoder_device = encoder_device
        self.decoder_device = decoder_device
        self.enc_params = jax.device_put(params, encoder_device)
        self.dec_params = jax.device_put(params, decoder_device)

        @device.jit
        def encode_stage(params, indices, mask):
            x = tfm.transform_embedding(tfm.embed(params, indices))
            mask_add = tfm.make_additive_mask(mask)
            return (
                tfm.encoder_forward(
                    params, x, mask_add, num_heads, provider
                ),
                mask_add,
            )

        self._encode = encode_stage

        def decode_stage(params, encoder_out, mask_add, *, eos_id, max_steps):
            return greedy_decode(
                params,
                encoder_out,
                mask_add,
                eos_id,
                max_steps,
                num_heads,
                provider,
            )

        self._decode = device.jit(
            decode_stage, static_argnames=("eos_id", "max_steps")
        )

    def translate_batches(
        self,
        batches: Sequence[Tuple[jnp.ndarray, jnp.ndarray]],
        eos_id: int,
        max_steps: int,
    ) -> List[GreedyResult]:
        """Pipelined run over [(indices, mask), ...]: encodes are
        dispatched ahead (stage A) while decodes (stage B) drain —
        JAX's async dispatch provides the overlap; the stage hop is
        one device_put."""
        encoded = []
        for indices, mask in batches:
            indices = jax.device_put(indices, self.encoder_device)
            mask = jax.device_put(mask, self.encoder_device)
            encoded.append(self._encode(self.enc_params, indices, mask))

        results = []
        for encoder_out, mask_add in encoded:
            encoder_out = jax.device_put(encoder_out, self.decoder_device)
            mask_add = jax.device_put(mask_add, self.decoder_device)
            results.append(
                self._decode(
                    self.dec_params,
                    encoder_out,
                    mask_add,
                    eos_id=eos_id,
                    max_steps=max_steps,
                )
            )
        return results
