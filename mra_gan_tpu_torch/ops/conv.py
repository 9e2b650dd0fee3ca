"""3D convolution primitives over torch.nn.functional (counterpart of
mra_gan_tpu/ops/conv.py:35,65,131).

Weights stay float32 and are cast to the activation's dtype at each call, as
the JAX Conv3D casts its kernel, so bfloat16 compute runs over float32
parameters; inside ``param_casts`` (each network apply of a train step) all
of a network's casts are made, and their gradients cast back, in one copy
each; without gradients (inference) a parameter's cast is kept until the
parameter changes. torch's ConvTranspose3d already has the reference's semantics
(out = (in - 1) * stride - 2 * pad + k + output_padding).

On CUDA the generator runs in channels_last_3d (NDHWC in memory, the layout of
the norm kernels); each op here returns that layout when its input has it.

Under ``core.spatial_ctx.spatial_sharding`` a volume is depth-sharded over a
process group: ``extend_sharded_d`` grows a shard by halo rows from its
neighbours (edge or zero rows at the volume's two ends), and
``replication_pad3d`` pads depth that way and H and W locally (JAX
ops/conv.py:96-150).

The replication pads go through the hand-written kernels of
``ops/kernels/replication_pad.py`` on CUDA (bfloat16, float32, float64),
forward and backward, and through their plain versions on the CPU; the
backward is a gather in a fixed order, so a train step's input gradients do
not change from run to run. Nothing here calls F.pad.

The 7^3 single-channel convs. ``conv3d`` sends every conv with a 7^3
kernel, stride 1, no padding and one input or one output channel (the
resnet generator's stem and head, on every path) to three custom ops,
``mra_torch::c7_convolution`` (the forward),
``mra_torch::c7_convolution_input_grad`` (its input gradient) and
``mra_torch::c7_convolution_weight_grad`` (its weight gradient), on every
device and dtype. The rule inside all three: a bfloat16 CUDA tensor
launches the hand-written kernels of ``ops/kernels/conv7.py`` (one input
channel: the forward spreads, the input gradient gathers and the weight
gradient is ``conv7_wgrad_spread``; one output channel: the reverse and
``conv7_wgrad_gather``), and raises where they cannot build or launch;
every other tensor (the CPU, float32 or float64 on CUDA) takes
``F.conv3d``, ``torch.nn.grad.conv3d_input`` and
``torch.nn.grad.conv3d_weight``, so float32 stays on cuDNN exactly as
before. The bias gradient, where the bias is live, is the output
gradient's sum in float32, rounded once, on the kernels' route, and
``aten.convolution_backward``'s elsewhere. The ops carry
torch.utils.flop_counter formulas, so FlopCounterMode counts them exactly as
it counts ``aten.convolution`` and the input and weight parts of
``aten.convolution_backward``. Where no dispatch mode is on, ``conv3d``
runs the same functions through the autograd Function ``C7Convolution``,
without the custom ops' dispatch.

The stride-2 4^3 one-channel convs. ``conv3d`` sends every conv with a (C,
1, 4, 4, 4) weight, stride 2 on every axis and a zero pad of 0 or 1 on each
axis (``single_channel_4s2``: the PatchGAN's first conv, the U-Net's
outermost down conv, its depth pad 0 on a depth shard) to three custom ops
of the same pattern, ``mra_torch::c4s2_convolution``,
``mra_torch::c4s2_convolution_input_grad`` and
``mra_torch::c4s2_convolution_weight_grad`` (the weight and the bias
gradient together), through the autograd Function ``C4S2Convolution`` where
no dispatch mode is on. A bfloat16 CUDA tensor launches
``ops/kernels/conv4s2.py``'s kernels (``conv4s2_spread``,
``conv4s2_gather``, ``conv4s2_wgrad`` and its reduce; no fallback); every
other tensor takes ``F.conv3d`` and aten's backward, as before. Their
backward computes only the gradients the running backward pass will use:
``needs_input_grad`` is fixed at the forward, so it also asks whether the
engine will run the node each gradient flows into (``_asked``); the train
step's generator update asks no gradient of the discriminators' weights."""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import conv_flop_count, register_flop_formula

from ..core.spatial_ctx import spatial_shard_info
from ..parallel.collectives import neighbour_exchange
from .kernels import conv4s2, conv7, replication_pad

_CL = torch.channels_last_3d
_TAPS = (7, 7, 7)
_TAPS4 = (4, 4, 4)


def _keep_layout(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda and x.is_contiguous(memory_format=_CL):
        return y.contiguous(memory_format=_CL)
    return y


def _triple(v) -> Tuple[int, int, int]:
    """An int for every axis, or one per axis (JAX ``_canon``)."""
    if isinstance(v, int):
        return (v, v, v)
    return tuple(int(x) for x in v)


def single_channel_7(weight_shape, stride=1, padding=0) -> bool:
    """Whether ``conv3d`` sends a conv to the c7 ops: a 7^3 kernel, stride
    1, no padding, and one input or one output channel."""
    cout, cin, *taps = weight_shape
    return (tuple(taps) == _TAPS and _triple(stride) == (1, 1, 1)
            and _triple(padding) == (0, 0, 0) and (cin == 1 or cout == 1))


def single_channel_4s2(weight_shape, stride=1, padding=0) -> bool:
    """Whether ``conv3d`` sends a conv to the c4s2 ops: a (C, 1, 4, 4, 4)
    weight, stride 2 on every axis and a zero pad of 0 or 1 on each axis."""
    cout, cin, *taps = weight_shape
    return (cin == 1 and tuple(taps) == _TAPS4 and _triple(stride) == (2, 2, 2)
            and all(p in (0, 1) for p in _triple(padding)))


def _on_kernels(t: torch.Tensor) -> bool:
    return t.is_cuda and t.dtype == torch.bfloat16


def _taps(weight: torch.Tensor, flip: bool) -> torch.Tensor:
    # (C, 1, 7, 7, 7) or (1, C, 7, 7, 7) -> (C, 7, 7, 7), flipped for an input gradient
    w = weight[:, 0] if weight.shape[1] == 1 else weight[0]
    return (w.flip(1, 2, 3) if flip else w).contiguous()


def _c7_forward(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    if not _on_kernels(x):
        return F.conv3d(x, weight, bias)
    if weight.shape[1] == 1:
        return conv7.conv7_spread(x.contiguous(), _taps(weight, False), bias)
    return conv7.conv7_gather(x.contiguous(memory_format=_CL), _taps(weight, False), bias)


def _c7_input_grad(grad: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    if not _on_kernels(grad):
        shape = (grad.shape[0], weight.shape[1], *(s + 6 for s in grad.shape[2:]))
        return torch.nn.grad.conv3d_input(shape, weight, grad)
    if weight.shape[1] == 1:
        return conv7.conv7_gather(grad.contiguous(memory_format=_CL), _taps(weight, True), None,
                                  6)
    return conv7.conv7_spread(grad.contiguous(), _taps(weight, True), None, 6)


def _c7_weight_grad(grad: torch.Tensor, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    if not _on_kernels(grad):
        return torch.nn.grad.conv3d_weight(x, weight.shape, grad)
    if weight.shape[1] == 1:
        dw = conv7.conv7_wgrad_spread(x.contiguous(), grad.contiguous(memory_format=_CL))
    else:
        dw = conv7.conv7_wgrad_gather(x.contiguous(memory_format=_CL), grad.contiguous())
    return dw.view(weight.shape)


@torch.library.custom_op("mra_torch::c7_convolution", mutates_args=())
def c7_convolution(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
    """F.conv3d(x, weight, bias) for a ``single_channel_7`` weight."""
    return _c7_forward(x, weight, bias)


@c7_convolution.register_fake
def _(x, weight, bias):
    return x.new_empty((x.shape[0], weight.shape[0], *(s - 6 for s in x.shape[2:])))


@torch.library.custom_op("mra_torch::c7_convolution_input_grad", mutates_args=())
def c7_convolution_input_grad(grad: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The gradient of ``c7_convolution`` with respect to x, from the
    gradient of its output: a transposed conv, each axis 6 longer."""
    return _c7_input_grad(grad, weight)


@c7_convolution_input_grad.register_fake
def _(grad, weight):
    return grad.new_empty((grad.shape[0], weight.shape[1], *(s + 6 for s in grad.shape[2:])))


@torch.library.custom_op("mra_torch::c7_convolution_weight_grad", mutates_args=())
def c7_convolution_weight_grad(grad: torch.Tensor, x: torch.Tensor,
                               weight: torch.Tensor) -> torch.Tensor:
    """The gradient of ``c7_convolution`` with respect to its weight (of
    ``weight``'s shape and dtype), from its input and the gradient of its
    output."""
    return _c7_weight_grad(grad, x, weight)


@c7_convolution_weight_grad.register_fake
def _(grad, x, weight):
    return weight.new_empty(weight.shape)


# the number of dispatch modes on the stack (FlopCounterMode, FakeTensorMode)
_DISPATCH_MODES = getattr(torch._C, "_len_torch_dispatch_stack", lambda: 1)


def _as_op(impl, op):
    """``op``, the custom op, where a dispatch mode is on the stack (a mode
    sees the custom op, not what runs inside it); else ``impl``, the same
    function without the custom op's dispatch, whose host time a train step
    would pay at each stem and head conv and at their gradients."""
    return op if _DISPATCH_MODES() else impl


def _c7_setup(ctx, inputs, output):
    x, weight, bias = inputs
    _, need_w, need_b = ctx.needs_input_grad[:3]
    ctx.has_bias = bias is not None
    ctx.save_for_backward(x if need_w or need_b else None, weight)  # x only for dW, db


def _c7_backward(ctx, grad):
    x, weight = ctx.saved_tensors
    need_x, need_w, need_b = ctx.needs_input_grad[:3]
    if _on_kernels(grad) and weight.shape[1] == 1 and not grad.is_contiguous(memory_format=_CL):
        # the stem's kernels (input and weight gradient) take g in channels_last_3d
        conv7.GRAD_RELAYOUTS["count"] += 1
        grad = grad.contiguous(memory_format=_CL)
    gx = _as_op(_c7_input_grad, c7_convolution_input_grad)(grad, weight) if need_x else None
    gw = _as_op(_c7_weight_grad, c7_convolution_weight_grad)(grad, x, weight) if need_w else None
    gb = _c7_bias_grad(grad, x, weight) if need_b and ctx.has_bias else None
    return gx, gw, gb


def _c7_bias_grad(grad: torch.Tensor, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The bias gradient. A bfloat16 gradient on the kernels' route: its sum
    in float32, rounded once. Any other (a float32 one included, which takes
    the kernels' route only where the tests put it there on the CPU): aten's,
    as before the c7 ops; aten's CPU sum runs in one sequential order."""
    if _on_kernels(grad) and grad.dtype == torch.bfloat16:
        return grad.sum((0, 2, 3, 4), dtype=torch.float32).to(grad.dtype)
    return torch.ops.aten.convolution_backward(
        grad, x, weight, [weight.shape[0]], [1] * 3, [0] * 3, [1] * 3, False, [0] * 3, 1,
        [False, False, True])[2]


c7_convolution.register_autograd(_c7_backward, setup_context=_c7_setup)


class C7Convolution(torch.autograd.Function):
    """``c7_convolution`` and its backward as a plain autograd Function:
    ``conv3d``'s route where no dispatch mode is on. The same functions run
    inside, so the results are the custom op's."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        out = _c7_forward(x, weight, bias)
        _c7_setup(ctx, (x, weight, bias), out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return _c7_backward(ctx, grad)


# ---------------------------------------------------------------------------
# the stride-2 4^3 one-channel convs (single_channel_4s2)

_WILL_RUN = getattr(torch._C, "_will_engine_execute_node", None)


def _asked(ctx, i: int) -> bool:
    """Whether the running backward wants the gradient of tensor input i (x,
    weight, bias): it needs one and the engine will run the node the
    gradient flows into. A torch.autograd.grad() over some parameters runs
    only their part of the graph (the generator's update runs no
    discriminator weight's cast), which ``needs_input_grad``, fixed at the
    forward, does not show."""
    if not ctx.needs_input_grad[i]:
        return False
    if _WILL_RUN is None:
        return True
    try:
        return bool(_WILL_RUN(ctx.next_functions[i][0]))
    except RuntimeError:  # a leaf that the running torch.autograd.grad() asks for
        return True


def _taps4(weight: torch.Tensor) -> torch.Tensor:
    # (C, 1, 4, 4, 4) -> (C, 4, 4, 4)
    return weight[:, 0].contiguous()


def _c4s2_forward(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                  padding: List[int]) -> torch.Tensor:
    if not _on_kernels(x):
        return F.conv3d(x, weight, bias, 2, tuple(padding))
    return conv4s2.conv4s2_spread(x.contiguous(), _taps4(weight), bias, tuple(padding))


def _c4s2_input_grad(grad: torch.Tensor, weight: torch.Tensor, padding: List[int],
                     box: List[int]) -> torch.Tensor:
    if not _on_kernels(grad):
        return torch.nn.grad.conv3d_input((grad.shape[0], 1, *box), weight, grad, 2,
                                          tuple(padding))
    return conv4s2.conv4s2_gather(grad.contiguous(memory_format=_CL), _taps4(weight),
                                  tuple(padding), tuple(box))


def _c4s2_weight_grad(grad: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                      padding: List[int], with_bias: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if not _on_kernels(grad):
        _, dw, db = torch.ops.aten.convolution_backward(
            grad, x, weight, [weight.shape[0]] if with_bias else None, [2] * 3, list(padding),
            [1] * 3, False, [0] * 3, 1, [False, True, with_bias])
        return dw, db if with_bias else grad.new_empty(0)
    dw, db = conv4s2.conv4s2_wgrad(x.contiguous(), grad.contiguous(memory_format=_CL),
                                   tuple(padding))
    return dw.view(weight.shape), db if with_bias else db.new_empty(0)


@torch.library.custom_op("mra_torch::c4s2_convolution", mutates_args=())
def c4s2_convolution(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                     padding: List[int]) -> torch.Tensor:
    """F.conv3d(x, weight, bias, 2, padding) for a ``single_channel_4s2``
    weight; ``padding`` per axis."""
    return _c4s2_forward(x, weight, bias, padding)


@c4s2_convolution.register_fake
def _(x, weight, bias, padding):
    return x.new_empty((x.shape[0], weight.shape[0], *conv4s2.out_shape(x.shape[2:], padding)))


@torch.library.custom_op("mra_torch::c4s2_convolution_input_grad", mutates_args=())
def c4s2_convolution_input_grad(grad: torch.Tensor, weight: torch.Tensor, padding: List[int],
                                box: List[int]) -> torch.Tensor:
    """The gradient of ``c4s2_convolution`` with respect to x, whose box is
    ``box``, from the gradient of its output."""
    return _c4s2_input_grad(grad, weight, padding, box)


@c4s2_convolution_input_grad.register_fake
def _(grad, weight, padding, box):
    return grad.new_empty((grad.shape[0], 1, *box))


@torch.library.custom_op("mra_torch::c4s2_convolution_weight_grad", mutates_args=())
def c4s2_convolution_weight_grad(grad: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                                 padding: List[int],
                                 with_bias: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``c4s2_convolution`` with respect to its weight (of
    ``weight``'s shape and dtype) and, ``with_bias``, its bias ((C,); else
    an empty tensor), from its input and the gradient of its output."""
    return _c4s2_weight_grad(grad, x, weight, padding, with_bias)


@c4s2_convolution_weight_grad.register_fake
def _(grad, x, weight, padding, with_bias):
    return weight.new_empty(weight.shape), weight.new_empty(weight.shape[0] if with_bias else 0)


def _c4s2_setup(ctx, inputs, output):
    x, weight, bias, padding = inputs
    _, need_w, need_b = ctx.needs_input_grad[:3]
    ctx.padding, ctx.box, ctx.has_bias = list(padding), list(x.shape[2:]), bias is not None
    ctx.save_for_backward(x if need_w or need_b else None, weight)  # x only for dW, db


def _c4s2_backward(ctx, grad):
    x, weight = ctx.saved_tensors
    need_x, need_w, need_b = (_asked(ctx, i) for i in range(3))
    if _on_kernels(grad) and not grad.is_contiguous(memory_format=_CL):
        # the gather and the weight gradient take g in channels_last_3d
        conv4s2.RELAYOUTS["count"] += 1
        grad = grad.contiguous(memory_format=_CL)
    gx = gw = gb = None
    if need_x:
        gx = _as_op(_c4s2_input_grad, c4s2_convolution_input_grad)(grad, weight, ctx.padding,
                                                                   ctx.box)
    if need_w or need_b:
        gw, gb = _as_op(_c4s2_weight_grad, c4s2_convolution_weight_grad)(
            grad, x, weight, ctx.padding, ctx.has_bias)
        gw, gb = (gw if need_w else None), (gb if need_b else None)
    return gx, gw, gb, None


c4s2_convolution.register_autograd(_c4s2_backward, setup_context=_c4s2_setup)


class C4S2Convolution(torch.autograd.Function):
    """``c4s2_convolution`` and its backward as a plain autograd Function:
    ``conv3d``'s route where no dispatch mode is on, as ``C7Convolution``."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding):
        out = _c4s2_forward(x, weight, bias, padding)
        _c4s2_setup(ctx, (x, weight, bias, padding), out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return _c4s2_backward(ctx, grad)


@register_flop_formula([torch.ops.mra_torch.c7_convolution,
                        torch.ops.mra_torch.c4s2_convolution])
def _conv_flops(x_shape, w_shape, bias_shape, *args, out_shape, **kwargs) -> int:
    return conv_flop_count(x_shape, w_shape, out_shape, transposed=False)


@register_flop_formula([torch.ops.mra_torch.c7_convolution_input_grad,
                        torch.ops.mra_torch.c4s2_convolution_input_grad])
def _input_grad_flops(grad_shape, w_shape, *args, out_shape, **kwargs) -> int:
    # as aten.convolution_backward counts an input gradient
    return conv_flop_count(grad_shape, w_shape, out_shape, transposed=True)


@register_flop_formula([torch.ops.mra_torch.c7_convolution_weight_grad,
                        torch.ops.mra_torch.c4s2_convolution_weight_grad])
def _weight_grad_flops(grad_shape, x_shape, w_shape, *args, out_shape, **kwargs) -> int:
    # as aten.convolution_backward counts a weight gradient: conv(x, grad);
    # the c4s2 op's bias gradient, as aten's, counts nothing
    def t(shape):
        return [shape[1], shape[0], *shape[2:]]

    return conv_flop_count(t(x_shape), t(grad_shape), t(w_shape), transposed=False)


# {id(parameter): its cast} inside ``param_casts``
_PARAM_CASTS: contextvars.ContextVar = contextvars.ContextVar("mra_torch_param_casts",
                                                              default=None)


class CastParams(torch.autograd.Function):
    """A network's parameters cast to ``dtype`` in one foreach copy, and
    the casts' gradients cast back in another: a train step would otherwise
    cast each weight and bias of each network apply, and each gradient
    back, one launch and one autograd node apiece. Each cast and each
    gradient is ``t.to(dtype)``'s and its backward's, bit for bit; a cast
    that no gradient reaches gives its parameter none."""

    @staticmethod
    def forward(ctx, dtype, *params):
        ctx.set_materialize_grads(False)
        ctx.dtypes = [p.dtype for p in params]
        casts = [torch.empty_like(p, dtype=dtype) for p in params]
        torch._foreach_copy_(casts, list(params))
        return tuple(casts)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        live = [i for i, g in enumerate(grads) if g is not None]
        out = [None] * len(grads)
        if live:
            back = [torch.empty_like(grads[i], dtype=ctx.dtypes[i]) for i in live]
            torch._foreach_copy_(back, [grads[i] for i in live])
            for i, g in zip(live, back):
                out[i] = g
        return (None, *out)


@contextlib.contextmanager
def param_casts(net: torch.nn.Module, dtype: torch.dtype):
    """Inside, ``_cast`` (every conv's weight and bias) takes ``net``'s
    parameters cast to ``dtype`` by one ``CastParams``, where a gradient is
    recorded; elsewhere, or where no parameter needs the cast, nothing
    changes."""
    params = ([p for p in net.parameters() if p.dtype != dtype and p.is_floating_point()]
              if torch.is_grad_enabled() else [])
    if not params:
        yield
        return
    casts = CastParams.apply(dtype, *params)
    token = _PARAM_CASTS.set({id(p): c for p, c in zip(params, casts)})
    try:
        yield
    finally:
        _PARAM_CASTS.reset(token)


def param_cast(t: torch.Tensor) -> torch.Tensor:
    """The cast of parameter ``t`` that ``param_casts`` made, else ``t``."""
    casts = _PARAM_CASTS.get()
    return t if casts is None else casts.get(id(t), t)


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """``t`` in ``dtype``. Inside ``param_casts`` a parameter takes the cast
    made there. Where no gradient is recorded (inference), a parameter's
    cast is kept on it and made again only once the parameter has changed
    (its version, storage, device), so a decode casts each weight once and
    not at every patch batch; the bits are the same either way."""
    if t is None or t.dtype == dtype:
        return t
    held = param_cast(t)
    if held.dtype == dtype:
        return held
    if torch.is_grad_enabled() or not isinstance(t, torch.nn.Parameter):
        return t.to(dtype)
    key = (t._version, t.data_ptr(), t.device, dtype)
    held = getattr(t, "_mra_cast", None)
    if held is None or held[0] != key:
        held = (key, t.to(dtype))
        t._mra_cast = held
    return held[1]


def conv3d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride=1, padding=0) -> torch.Tensor:
    """x (N, Cin, D, H, W); weight (Cout, Cin, kd, kh, kw). A
    ``single_channel_7`` conv goes through ``c7_convolution``, a
    ``single_channel_4s2`` conv through ``c4s2_convolution``."""
    b, w = _cast(bias, x.dtype), _cast(weight, x.dtype)
    if single_channel_7(weight.shape, stride, padding):
        return _keep_layout(_as_op(C7Convolution.apply, c7_convolution)(x, w, b), x)
    if single_channel_4s2(weight.shape, stride, padding):
        pads = list(_triple(padding))
        return _keep_layout(_as_op(C4S2Convolution.apply, c4s2_convolution)(x, w, b, pads), x)
    return _keep_layout(F.conv3d(x, w, b, stride, padding), x)


def conv_transpose3d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride=2, padding=1,
                     output_padding=0) -> torch.Tensor:
    """x (N, Cin, D, H, W); weight (Cin, Cout, kd, kh, kw)."""
    y = F.conv_transpose3d(x, _cast(weight, x.dtype), _cast(bias, x.dtype), stride, padding,
                           output_padding)
    return _keep_layout(y, x)


def extend_sharded_d(x: torch.Tensor, lo: int, hi: int, boundary: str = "edge") -> torch.Tensor:
    """Extend a depth shard (N, C, D/K, H, W) by ``lo`` rows above and ``hi``
    below, from the neighbouring shards, and at the volume's ends the edge
    row repeated ('edge') or zeros ('zero'): the shard's part of the whole
    volume padded so (JAX ``extend_sharded_d``). Needs lo, hi <= D/K; only
    inside ``spatial_sharding``."""
    axis = spatial_shard_info()
    if axis is None:
        raise RuntimeError("extend_sharded_d needs spatial_sharding()")
    return neighbour_exchange(x, lo, hi, boundary, axis.group)


class ReplicationPad(torch.autograd.Function):
    """``replication_pad.replication_pad_fwd`` with its fixed-order backward,
    ``replication_pad_bwd``: the kernels on CUDA, their plain versions on
    the CPU."""

    @staticmethod
    def forward(ctx, x, pads):
        ctx.pads, ctx.box = pads, tuple(x.shape[2:])
        return replication_pad.replication_pad_fwd(x, pads)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return replication_pad.replication_pad_bwd(g, ctx.pads, ctx.box), None


def replication_pad3d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicate ``pad`` voxels on each side of D, H and W (torch
    nn.ReplicationPad3d); under spatial sharding the depth pad is a halo
    exchange with edge rows at the volume's ends, and the kernels pad H and
    W. Where autograd records nothing (a decode) the forward runs without
    the autograd Function."""
    pads = (pad,) * 6
    if spatial_shard_info() is not None:
        x = extend_sharded_d(x, pad, pad, "edge")
        pads = (0, 0) + pads[2:]
    if torch.is_grad_enabled() and x.requires_grad:
        return ReplicationPad.apply(x, pads)
    return replication_pad.replication_pad_fwd(x, pads)
