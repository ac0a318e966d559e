"""What the plain references share: Adam, the loss, the matrix product
and its control precision, and the readings of three training steps.

Plain PyTorch; imports nothing of the program. The control computes every
matrix product with its operands rounded to TF32 (10 mantissa bits, to
nearest, ties away from zero, as the tensor cores' TF32 conversion),
forward and backward, so that it means the same on the CPU and the card.
"""

import torch

# The fault "an answer altered where it is produced": these first rows of
# every aggregation's output doubled, as a kernel that got one tile of 128
# rows wrong would leave them.
ALTERED_ROWS = 128


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to TF32's 10 mantissa bits, kept as f32."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(b).t(), to_tf32(a).t() @ g


def matmul(a, b, tf32: bool = False):
    """``a @ b`` in f32, or in the control's TF32."""
    return _TF32MatMul.apply(a, b) if tf32 else a @ b


def cross_entropy(logits, y):
    """The mean negative log-likelihood of ``y`` under
    ``log_softmax(logits)``."""
    logp = logits - torch.logsumexp(logits, dim=1, keepdim=True)
    return -logp.gather(1, y[:, None]).mean()


class Adam:
    """Adam's update, written out: ``m = b1 m + (1 - b1) g``, ``v = b2 v +
    (1 - b2) g^2``, ``p -= lr m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) +
    eps)``."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params = params
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def precision(tf32: bool) -> torch.dtype:
    """The reference computes in f64, so that a comparison sees the
    program's rounding alone; the control in f32 with TF32 products."""
    return torch.float32 if tf32 else torch.float64


def train_three(params, loss_of, cfg, steps: int = 3, update: bool = True,
                dtype=torch.float64) -> dict:
    """``steps`` Adam steps from copies of ``params`` (a list of leaves)
    in ``dtype``; ``loss_of(leaves, k)`` gives step ``k``'s loss. Returns
    the losses, the first gradient and the change of each leaf.
    ``update=False`` leaves the parameters as they were (a stale step, as
    a fault)."""
    params = [p.detach().to(dtype) for p in params]
    leaves = [p.clone().requires_grad_() for p in params]
    opt = Adam(leaves, cfg['lr'], tuple(cfg['betas']), cfg['eps'])
    losses, first = [], None
    for k in range(steps):
        loss = loss_of(leaves, k)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if first is None:
            first = [g.detach().clone() for g in grads]
        if update:
            opt.step(grads)
    return {'losses': losses, 'grads': first,
            'change': [(p.detach() - p0).clone()
                       for p, p0 in zip(leaves, params)]}
