"""BatchNorm with its batch statistics taken over every rank's rows.

Under ``jit`` over a mesh, the JAX package's BatchNorm (``TorchBatchNorm``,
``pranet2_tpu/nn.py:25-74``) computes its statistics over the global batch.
``SyncBatchNorm`` does the same across processes, with the port's
BatchNorm semantics kept exactly (``nn.BatchNorm2d(eps=1e-5,
momentum=0.1)``): the biased variance normalises, the running variance is
updated with the global count's n / (n - 1), the arithmetic runs in
float32 for bf16 and float32 inputs (float64 for float64) and the output
comes back in the input's type.

``torch.nn.SyncBatchNorm`` is not used: in a gloo group it refuses CPU
tensors, and the CPU tests run the ranks on the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn


def _compute_type(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


class _SyncBatchNormFn(torch.autograd.Function):
    """Train-mode batch norm over the ranks' rows together.

    Forward: one ``all_reduce`` of (sum, sum of squares, count), in
    float64 whatever the input's type, so that the variance's
    E[x^2] - mean^2 keeps the compute type's precision.  Backward: one
    ``all_reduce`` of (sum dy, sum dy * x_hat); the weight's and bias's
    gradients are this rank's own sums, which the data-parallel wrapper
    averages with the others'.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum):
        ct = _compute_type(x.dtype)
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = [1, c] + [1] * (x.dim() - 2)
        xf = x.to(ct)
        n_local = x.numel() // c
        # local mean and variance in the compute type (ATen's two-pass
        # accuracy), then the sums in float64 for the reduction
        var_l, mean_l = torch.var_mean(xf, dim=dims, correction=0)
        mean_l, var_l = mean_l.double(), var_l.double()
        stats = torch.cat([mean_l * n_local,
                           (var_l + mean_l * mean_l) * n_local,
                           mean_l.new_full((1,), float(n_local))])
        dist.all_reduce(stats)
        n = stats[-1]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            running_mean.mul_(1.0 - momentum).add_(
                (momentum * mean).to(running_mean.dtype))
            running_var.mul_(1.0 - momentum).add_(
                (momentum * var * (n / (n - 1.0))).to(running_var.dtype))
        mean, invstd = mean.to(ct), torch.rsqrt(var + eps).to(ct)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        y = xhat * weight.to(ct).view(shape) + bias.to(ct).view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n.to(ct))
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        ct = mean.dtype
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = [1, c] + [1] * (x.dim() - 2)
        xhat = (x.to(ct) - mean.view(shape)) * invstd.view(shape)
        dyf = dy.to(ct)
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = (dyf * xhat).sum(dims)
        sums = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums)
        g_dy, g_dy_xhat = sums[:c] / n, sums[c:] / n
        dx = (invstd * weight.to(ct)).view(shape) * (
            dyf - g_dy.view(shape) - xhat * g_dy_xhat.view(shape))
        return (dx.to(x.dtype), sum_dy_xhat.to(weight.dtype),
                sum_dy.to(weight.dtype), None, None, None, None)


class SyncBatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics are those of the
    global batch, over the ranks of the default process group.

    Eval mode uses the running statistics and communicates nothing; in
    train mode without a process group, or in a group of one process, it
    is ``nn.BatchNorm2d`` itself (``F.batch_norm``): a world of 1 computes
    exactly what one device computes.  The parameters, buffers and
    ``state_dict`` keys are ``nn.BatchNorm2d``'s.
    """

    def forward(self, x):
        if not (self.training and dist.is_initialized()
                and dist.get_world_size() > 1):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        return _SyncBatchNormFn.apply(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.eps, self.momentum)


def convert_sync_batchnorm(module: nn.Module) -> nn.Module:
    """Swap every ``nn.BatchNorm2d`` of ``module`` (in place) for a
    ``SyncBatchNorm`` holding the same parameters and buffers; no other
    module changes (LayerNorm stays per-sample).  Returns ``module``, or
    its replacement when ``module`` is itself a BatchNorm.  The port's
    BatchNorms are affine and keep running statistics at a fixed
    momentum, which ``SyncBatchNorm`` assumes."""
    if isinstance(module, nn.BatchNorm2d) and not isinstance(
            module, SyncBatchNorm):
        sync = SyncBatchNorm(module.num_features, module.eps,
                             module.momentum, module.affine,
                             module.track_running_stats)
        sync.weight, sync.bias = module.weight, module.bias
        sync.running_mean = module.running_mean
        sync.running_var = module.running_var
        sync.num_batches_tracked = module.num_batches_tracked
        sync.train(module.training)
        return sync
    for name, child in module.named_children():
        new = convert_sync_batchnorm(child)
        if new is not child:
            setattr(module, name, new)
    return module
