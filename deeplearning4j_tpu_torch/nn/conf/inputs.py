"""Input types + automatic shape inference / preprocessor insertion.

Copy of ``deeplearning4j_tpu/nn/conf/inputs.py`` for the torch package
(the same beans and the same inference, so ``set_input_type`` gives the
same conf JSON). Mirror of reference nn/conf/inputs/InputType.java and
nn/conf/layers/setup/ConvolutionLayerSetup.java:36: walk the layer list,
compute each layer's input/output type, fill in ``n_in``/``n_out`` channel
and size fields, and insert the right InputPreProcessor at every
representation boundary (CNN<->FF<->RNN).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
    CnnToRnnPreProcessor,
    FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    RnnToCnnPreProcessor,
    RnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.conf.serde import register_bean


@dataclasses.dataclass
class InputType:
    @staticmethod
    def feed_forward(size: int) -> "InputTypeFeedForward":
        return InputTypeFeedForward(size=size)

    @staticmethod
    def recurrent(size: int) -> "InputTypeRecurrent":
        return InputTypeRecurrent(size=size)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputTypeConvolutional":
        return InputTypeConvolutional(
            height=height, width=width, channels=channels
        )


@register_bean("InputTypeFeedForward")
@dataclasses.dataclass
class InputTypeFeedForward(InputType):
    size: int = 0


@register_bean("InputTypeRecurrent")
@dataclasses.dataclass
class InputTypeRecurrent(InputType):
    size: int = 0


@register_bean("InputTypeConvolutional")
@dataclasses.dataclass
class InputTypeConvolutional(InputType):
    height: int = 0
    width: int = 0
    channels: int = 1


def _conv_out(size: int, k: int, s: int, p: int) -> int:
    out = (size + 2 * p - k) // s + 1
    if out <= 0:
        raise ValueError(
            f"Invalid conv/pool geometry: size={size} kernel={k} "
            f"stride={s} pad={p}"
        )
    return out


def setup_shapes(conf, input_type: InputType) -> None:
    """Infer n_in/n_out for every layer of a MultiLayerConfiguration and
    insert preprocessors at representation boundaries (reference
    ConvolutionLayerSetup). Mutates ``conf`` in place."""
    cur = input_type
    for i, c in enumerate(conf.confs):
        lc = c.layer
        pp = conf.preprocessor_for(i)
        if pp is None:
            pp = _boundary_preprocessor(cur, lc)
            if pp is not None:
                conf.input_preprocessors[str(i)] = pp
        cur = _apply_preprocessor_type(cur, pp)
        cur = _fill_and_advance(lc, cur)


def _boundary_preprocessor(cur: InputType, lc: L.Layer):
    if isinstance(lc, (L.BatchNormalization, L.LayerNormalization)):
        return None  # shape-preserving in every representation
    wants_cnn = isinstance(lc, (L.ConvolutionLayer, L.SubsamplingLayer,
                                L.LocalResponseNormalization))
    wants_rnn = isinstance(lc, L.RECURRENT_LAYER_TYPES)
    if isinstance(cur, InputTypeConvolutional):
        if wants_cnn:
            return None
        if wants_rnn:
            return CnnToRnnPreProcessor(
                cur.height, cur.width, cur.channels
            )
        return CnnToFeedForwardPreProcessor(
            cur.height, cur.width, cur.channels
        )
    if isinstance(cur, InputTypeRecurrent):
        if wants_rnn:
            return None
        if wants_cnn:
            raise ValueError(
                "RNN -> CNN requires an explicit RnnToCnnPreProcessor with "
                "image geometry"
            )
        return RnnToFeedForwardPreProcessor()
    # FeedForward input
    if wants_cnn:
        raise ValueError(
            "FF -> CNN requires an explicit FeedForwardToCnnPreProcessor "
            "with image geometry"
        )
    if wants_rnn:
        return FeedForwardToRnnPreProcessor()
    return None


def _apply_preprocessor_type(cur: InputType, pp) -> InputType:
    if pp is None:
        return cur
    if isinstance(pp, CnnToFeedForwardPreProcessor):
        return InputType.feed_forward(
            pp.input_height * pp.input_width * pp.num_channels
            if pp.input_height
            else cur.height * cur.width * cur.channels
        )
    if isinstance(pp, CnnToRnnPreProcessor):
        return InputType.recurrent(
            pp.input_height * pp.input_width * pp.num_channels
        )
    if isinstance(pp, RnnToFeedForwardPreProcessor):
        return InputType.feed_forward(cur.size)
    if isinstance(pp, FeedForwardToRnnPreProcessor):
        return InputType.recurrent(cur.size)
    if isinstance(pp, FeedForwardToCnnPreProcessor):
        return InputType.convolutional(
            pp.input_height, pp.input_width, pp.num_channels
        )
    if isinstance(pp, RnnToCnnPreProcessor):
        return InputType.convolutional(
            pp.input_height, pp.input_width, pp.num_channels
        )
    return cur


def _fill_and_advance(lc: L.Layer, cur: InputType) -> InputType:
    """Set lc.n_in from ``cur``, return the layer's output type."""
    if isinstance(lc, L.ConvolutionLayer):
        if not isinstance(cur, InputTypeConvolutional):
            raise ValueError("ConvolutionLayer needs convolutional input")
        if not lc.n_in:
            lc.n_in = cur.channels
        kh, kw = lc.kernel_size
        sh, sw = lc.stride
        ph, pw = lc.padding
        return InputType.convolutional(
            _conv_out(cur.height, kh, sh, ph),
            _conv_out(cur.width, kw, sw, pw),
            lc.n_out,
        )
    if isinstance(lc, L.SubsamplingLayer):
        if not isinstance(cur, InputTypeConvolutional):
            raise ValueError("SubsamplingLayer needs convolutional input")
        kh, kw = lc.kernel_size
        sh, sw = lc.stride
        ph, pw = lc.padding
        return InputType.convolutional(
            _conv_out(cur.height, kh, sh, ph),
            _conv_out(cur.width, kw, sw, pw),
            cur.channels,
        )
    if isinstance(lc, L.LocalResponseNormalization):
        return cur
    if isinstance(lc, (L.BatchNormalization, L.LayerNormalization)):
        # Pure normalizers: representation-preserving (the input type
        # passes through unchanged — no FF coercion of recurrent/CNN
        # activations).
        if isinstance(cur, InputTypeConvolutional):
            if not lc.n_in:
                lc.n_in = cur.channels
        elif isinstance(cur, (InputTypeFeedForward, InputTypeRecurrent)):
            if not lc.n_in:
                lc.n_in = cur.size
        if not lc.n_out:
            lc.n_out = lc.n_in
        return cur
    if isinstance(lc, L.RECURRENT_LAYER_TYPES):
        if not isinstance(cur, InputTypeRecurrent):
            raise ValueError(f"{type(lc).__name__} needs recurrent input")
        if not lc.n_in:
            lc.n_in = cur.size
        return InputType.recurrent(lc.n_out)
    if isinstance(lc, L.FeedForwardLayer):
        size = cur.size if isinstance(
            cur, (InputTypeFeedForward, InputTypeRecurrent)
        ) else cur.height * cur.width * cur.channels
        if not lc.n_in:
            lc.n_in = size
        return InputType.feed_forward(lc.n_out)
    # Parameter-free layers keep the type.
    return cur
