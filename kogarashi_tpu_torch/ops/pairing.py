"""The device pairing: P1-P3 (`csrc/pairing.cu`) and their plain PyTorch
versions.

Counterpart of `kogarashi_tpu/ops/pairing.py`, with its public names: the
Fq12 tower ops (`f12_mul`, `f12_sq`, `f12_inv`, `f12_frobenius`,
`f12_conj`, `f12_mul_by_034`), `encode_fq12` / `decode_fq12`, the fold
flags (`_FOLD_FLAGS`) and line coefficients (`_encode_prepared`),
`multi_miller_loop_device`, `final_exp_device` and `pairing_device`. The
JAX package runs them as XLA programs (no Pallas kernel); here the Miller
loop (P1) and the final exponentiation (P2) are one launch each, one block
of threads (csrc/pairing.cu `kPairT`) running a schedule
(`pairing_schedule.py`: each tower op as one level of independent Fq
products), and the tower ops one launch over a batch of lanes (P3): below
a lane count `P3_ROUTES` sets, on the schedule route (the op's schedule,
`pairing_schedule.f12_op`, a block of threads a lane), above it on the
thread route (one thread a lane). As there, the host keeps the G2
precompute (`pyref.pairing_fast.G2Prepared`) and the scaling of the line
coefficients by P's coordinates.

Layout: an Fq12 is (96, *batch) int32 words, its 12 Fq components in
`Fq12.to_fq_list` order, 8 Montgomery words each (R = 2^256), canonical in
and out. The plain versions run on 16-bit halves in an (32, 2, 3, *batch)
int64 tensor: Fq2 halves (c0's 16 then c1's), then the Fq12's and Fq6's
component axes, so one call of the `fields.mont` engine covers every
component at once, and each Karatsuba level's independent products go
through one multiply.

Dispatch: a CUDA tensor launches the kernel (and counts the launch in
`LAUNCHES`, P3's also by route in `ROUTE_LAUNCHES`); a CPU tensor runs the
plain version. There is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..devices import resolve
from ..fields import mont
from ..fields.spec import FQ
from ..pyref import Fq, Fq12
from ..pyref.pairing_fast import G2Prepared
from ..pyref.tower import FROB_FQ6_C1, FROB_FQ6_C2, FROB_FQ12_C1
from . import _build, ec
from . import pairing_schedule as schedule

KERNELS = ("pair_miller_loop", "pair_final_exp", "f12_map")
LAUNCHES: dict = {k: 0 for k in KERNELS}
# P3's ops, by the code csrc/pairing.cu's `F12Op` gives them
OPS = {"mul": 0, "sq": 1, "inv": 2, "frobenius": 3, "conj": 4, "mul_by_034": 5}
# P3's routes: "schedule" (csrc/pairing.cu f12_sched_kernel, the op's
# schedule on a block of kPairT threads a lane) and "thread" (f12_map_kernel,
# one thread a lane). op -> ((lanes at least, route), ...): a launch over n
# lanes takes the route of the first row whose bound n meets. The rows come
# from timing both routes at every op from 1 to 2^16 lanes on an H100
# (profile_pairing.py, PERF.md): each threshold is the first lane count
# swept at which the thread route was the faster, as it was at every count
# above. conj makes no product, and one thread a lane was faster at every
# count.
ROUTES = ("schedule", "thread")
P3_ROUTES = {
    "mul": ((6144, "thread"), (0, "schedule")),
    "sq": ((5120, "thread"), (0, "schedule")),
    "inv": ((1024, "thread"), (0, "schedule")),
    "frobenius": ((3072, "thread"), (0, "schedule")),
    "conj": ((0, "thread"),),
    "mul_by_034": ((5120, "thread"), (0, "schedule")),
}
ROUTE_LAUNCHES: dict = {r: 0 for r in ROUTES}

F2 = mont.field(FQ, 2)
F = F2.base


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for r in ROUTES:
        ROUTE_LAUNCHES[r] = 0


def p3_route(op: str, n: int) -> str:
    """P3's route for `op` over n lanes (P3_ROUTES)."""
    return next(route for least, route in P3_ROUTES[op] if n >= least)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def _h(w):
    """(96, *b) words -> (32, 2, 3, *b) halves."""
    b = w.shape[1:]
    return mont.to_halves(w.reshape(2, 3, 16, *b).movedim(2, 0))


def _w(h):
    """(32, 2, 3, *b) halves -> (96, *b) words."""
    return mont.to_words(h).movedim(0, 2).reshape(96, *h.shape[3:]).contiguous()


def encode_fq12(x, device=None):
    """A pyref Fq12 -> (96,) words, or a list of them -> (96, n), on
    `device` (None: the card)."""
    device = resolve(device)
    xs = [x] if isinstance(x, Fq12) else list(x)
    vals = [v.v for e in xs for v in e.to_fq_list()]
    w = torch.from_numpy(FQ.encode(vals)).reshape(8, len(xs), 12).permute(2, 0, 1).reshape(96, len(xs))
    return (w[:, 0] if isinstance(x, Fq12) else w).contiguous().to(device)


def decode_fq12(a):
    """(96,) words -> a pyref Fq12; (96, n) -> a list of n."""
    w = a.detach().cpu().numpy().reshape(12, 8, -1)
    out = []
    for c in range(w.shape[2]):
        vals = FQ.decode(w[:, :, c].T)
        out.append(Fq12.from_fq_list([Fq(v) for v in vals]))
    return out[0] if a.dim() == 1 else out


def f12_one_words(device):
    return encode_fq12(Fq12.one(), device)


def _on(device, name: str, make):
    """A constant tensor, made once per device."""
    key = (name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = make().to(device)
    return t


_CONSTS: dict = {}


def frobenius_table(device):
    """(12, 48) words: per power, FQ6_C1, FQ6_C2 and FQ12_C1 of that power
    (pyref/tower.py), each an Fq2's 16 Montgomery words; P2 and P3 read it."""
    def make():
        vals = [v for p in range(12) for c in (FROB_FQ6_C1[p % 6], FROB_FQ6_C2[p % 6], FROB_FQ12_C1[p])
                for v in (c.c0.v, c.c1.v)]
        return torch.from_numpy(np.ascontiguousarray(FQ.encode(vals).T)).reshape(12, 48)

    return _on(device, "frobenius", make)

# ---------------------------------------------------------------------------
# the tower on halves (plain versions): Fq2 (32, *b), Fq6 (32, 3, *b),
# Fq12 (32, 2, 3, *b)
# ---------------------------------------------------------------------------


def _st(xs, dim=1):
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    return torch.stack([x.expand(shape) for x in xs], dim)


def f2_conj(a):
    return torch.cat([a[:16], F.neg(a[16:])])


def f2_mul_xi(a):
    """* (9 + u): (9 a0 - a1, 9 a1 + a0)."""
    x2 = F2.add(a, a)
    x4 = F2.add(x2, x2)
    x8 = F2.add(x4, x4)
    n = F2.add(x8, a)
    return torch.cat([F.sub(n[:16], a[16:]), F.add(n[16:], a[:16])])


def f6_mul_nonres(a):
    """* v: (xi c2, c0, c1)."""
    return _st([f2_mul_xi(a[:, 2]), a[:, 0], a[:, 1]])


def f6_mul(a, b):
    """Karatsuba over Fq2: 6 Fq2 products in one multiply."""
    a, b = torch.broadcast_tensors(a, b)
    s = F2.add(_st([a[:, 1], a[:, 0], a[:, 0], b[:, 1], b[:, 0], b[:, 0]]),
               _st([a[:, 2], a[:, 1], a[:, 2], b[:, 2], b[:, 1], b[:, 2]]))
    m = F2.mul(torch.cat([a, s[:, :3]], 1), torch.cat([b, s[:, 3:]], 1))
    t0, t1, t2 = m[:, 0], m[:, 1], m[:, 2]
    u = F2.sub(m[:, 3:], _st([t1, t0, t0]))  # m12 - t1, m01 - t0, m02 - t0
    v = F2.sub(u, _st([t2, t1, t2]))
    x = f2_mul_xi(_st([v[:, 0], t2]))
    return F2.add(_st([t0, v[:, 1], v[:, 2]]), _st([x[:, 0], x[:, 1], t1]))


def f6_mul_by_01(a, b0, b1):
    """* (b0, b1, 0): 5 Fq2 products in one multiply."""
    s = F2.add(_st([a[:, 1], a[:, 0], a[:, 0], b0]), _st([a[:, 2], a[:, 2], a[:, 1], b1]))
    m = F2.mul(_st([a[:, 0], a[:, 1], s[:, 0], s[:, 1], s[:, 2]]), _st([b0, b1, b1, b0, s[:, 3]]))
    t0, t1 = m[:, 0], m[:, 1]
    u = F2.sub(m[:, 2:], _st([t1, t0, t0]))  # m12 - t1, m02 - t0, m01 - t0
    c0c2 = F2.add(_st([f2_mul_xi(u[:, 0]), u[:, 1]]), _st([t0, t1]))
    return _st([c0c2[:, 0], F2.sub(u[:, 2], t1), c0c2[:, 1]])


def f6_inv(a):
    sq = F2.sqr(a)  # a0^2, a1^2, a2^2
    m = F2.mul(_st([a[:, 1], a[:, 0], a[:, 0]]), _st([a[:, 2], a[:, 1], a[:, 2]]))
    x = f2_mul_xi(_st([m[:, 0], sq[:, 2]]))
    t = F2.sub(_st([sq[:, 0], x[:, 1], sq[:, 1]]), _st([x[:, 0], m[:, 1], m[:, 2]]))
    p = F2.mul(_st([a[:, 0], a[:, 2], a[:, 1]]), t)
    n = F2.add(p[:, 0], f2_mul_xi(F2.add(p[:, 1], p[:, 2])))
    d = F2.inv(n)
    return F2.mul(t, _st([d, d, d]))


def _f6_batch(xs):
    """Fq6s (32, 3, *b) -> one Fq6 batch (32, 3, k, *b)."""
    return _st(xs, 2)


def f12_mul_h(a, b):
    s = F2.add(_st([a[:, 0], b[:, 0]]), _st([a[:, 1], b[:, 1]]))
    m = f6_mul(_f6_batch([a[:, 0], a[:, 1], s[:, 0]]), _f6_batch([b[:, 0], b[:, 1], s[:, 1]]))
    t0, t1, t2 = m[:, :, 0], m[:, :, 1], m[:, :, 2]
    c1 = F2.sub(F2.sub(t2, t0), t1)
    return _st([F2.add(t0, f6_mul_nonres(t1)), c1])


def f12_sq_h(a):
    a0, a1 = a[:, 0], a[:, 1]
    s = F2.add(_st([a0, a0]), _st([a1, f6_mul_nonres(a1)]))
    m = f6_mul(_f6_batch([a0, s[:, 0]]), _f6_batch([a1, s[:, 1]]))
    t, u = m[:, :, 0], m[:, :, 1]
    c0 = F2.sub(F2.sub(u, t), f6_mul_nonres(t))
    return _st([c0, F2.add(t, t)])


def f12_conj_h(a):
    return _st([a[:, 0], F2.neg(a[:, 1])])


def f12_inv_h(a):
    m = f6_mul(_f6_batch([a[:, 0], a[:, 1]]), _f6_batch([a[:, 0], a[:, 1]]))
    d = f6_inv(F2.sub(m[:, :, 0], f6_mul_nonres(m[:, :, 1])))
    r = f6_mul(_f6_batch([a[:, 0], a[:, 1]]), _f6_batch([d, d]))
    return _st([r[:, :, 0], F2.neg(r[:, :, 1])])


def f12_mul_by_034_h(a, c0, c3, c4):
    """* (c0, 0, 0, c3, c4, 0), the line (fqn.rs:570); c0, c3, c4 Fq2s."""
    a0, a1 = a[:, 0], a[:, 1]
    t0 = F2.mul(*torch.broadcast_tensors(a0, _st([c0, c0, c0])))
    o = F2.add(c0, c3)
    t = f6_mul_by_01(_f6_batch([a1, F2.add(a0, a1)]), _st([c3, o]), _st([c4, c4]))
    t1, t2 = t[:, :, 0], t[:, :, 1]
    out0 = F2.add(f6_mul_nonres(t1), t0)
    out1 = F2.sub(F2.sub(t2, t0), t1)
    return _st([out0, out1])


def f12_frobenius_h(a, power: int):
    """x -> x^(q^power), with pyref/tower.py's coefficient tables."""
    power %= 12
    if power % 2:
        a = f2_conj(a)
    shape = a.shape[3:]

    def const(v):
        return F2.const((v.c0.v, v.c1.v), shape, a.device)

    c1, c2, w = const(FROB_FQ6_C1[power % 6]), const(FROB_FQ6_C2[power % 6]), const(FROB_FQ12_C1[power])
    m = F2.mul(_st([a[:, 0, 1], a[:, 0, 2], a[:, 1, 1], a[:, 1, 2]]), _st([c1, c2, c1, c2]))
    n = F2.mul(_st([a[:, 1, 0], m[:, 2], m[:, 3]]), _st([w, w, w]))
    return _st([_st([a[:, 0, 0], m[:, 0], m[:, 1]]), n])


def _one_h(shape, device):
    h = torch.zeros((32, 2, 3, *shape), dtype=torch.int64, device=device)
    h[:, 0, 0] = F2.one(shape, device)
    return h


# ---------------------------------------------------------------------------
# Miller loop and final exponentiation (plain versions)
# ---------------------------------------------------------------------------


_FOLD_FLAGS = schedule.fold_flags()
N_FOLDS = len(_FOLD_FLAGS)
N_SQUARES = int(_FOLD_FLAGS.sum())

_HARD_BITS = np.asarray(schedule.HARD_BITS, dtype=np.int32)


def _encode_prepared(pairs, device):
    """[(pyref G1 affine, G2Prepared)] -> (n_folds, n_pairs, 3, 16) int32
    words: per fold and pair the line's (c0, c1, c2), c0 scaled by p.y and
    c1 by p.x (the untwist scaling, done on the host)."""
    vals = []
    for p, q in pairs:
        if p.is_infinity or q.is_infinity:
            raise ValueError("an identity pair has no line coefficients")
        if len(q.coeffs) != N_FOLDS:
            raise ValueError(f"{len(q.coeffs)} line coefficients, the loop has {N_FOLDS} folds")
    for f in range(N_FOLDS):
        for p, q in pairs:
            c0, c1, c2 = q.coeffs[f]
            vals += [c0.c0.v * p.y.v, c0.c1.v * p.y.v, c1.c0.v * p.x.v, c1.c1.v * p.x.v, c2.c0.v, c2.c1.v]
    w = FQ.encode(vals).T.reshape(N_FOLDS, len(pairs), 3, 16)
    return torch.from_numpy(np.ascontiguousarray(w)).to(device)


def miller_loop_plain(coeffs):
    """P1's plain version: coeffs (n_folds, n_pairs, 3, 16) -> (96,)."""
    n_folds, n_pairs = coeffs.shape[:2]
    c = mont.to_halves(coeffs.movedim(3, 0))  # (32, n_folds, n_pairs, 3)
    acc = _one_h((), coeffs.device)
    for f in range(n_folds):
        if _FOLD_FLAGS[f]:
            acc = f12_sq_h(acc)
        for j in range(n_pairs):
            acc = f12_mul_by_034_h(acc, c[:, f, j, 0], c[:, f, j, 1], c[:, f, j, 2])
    return _w(acc)


def final_exp_plain(f):
    """P2's plain version: (96,) -> (96,). The hard part's multiply and
    square of each set bit run as one batched multiply."""
    a = _h(f)
    t = f12_mul_h(f12_conj_h(a), f12_inv_h(a))
    t = f12_mul_h(f12_frobenius_h(t, 2), t)
    result = _one_h((), f.device)
    bits = _HARD_BITS.tolist()
    for i, bit in enumerate(bits):
        last = i + 1 == len(bits)
        if bit and not last:
            both = f12_mul_h(_st([result, t], 3), _st([t, t], 3))
            result, t = both[:, :, :, 0], both[:, :, :, 1]
        elif bit:
            result = f12_mul_h(result, t)
        elif not last:
            t = f12_sq_h(t)
    return _w(result)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _on_card(*ts) -> bool:
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 words, got {t.dtype}")
        if t.device != dev:
            raise ValueError("all operands must share one device")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _launch(kernel: str, device, entry: str, *args):
    """One launch of `kernel` through the library's kt_`entry`."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        rc = getattr(_build.lib(), f"kt_{entry}")(*args, stream)
    _build.check(rc, entry)
    LAUNCHES[kernel] += 1


def _check_fq12(a, rows: int = 96):
    if a.dim() < 1 or a.shape[0] != rows:
        raise ValueError(f"expected ({rows}, ...) words, got {tuple(a.shape)}")


def map_plain(op: str, a, b=None, power: int = 0):
    """P3's plain version, on the operands' device."""
    ah = _h(a)
    if op == "mul":
        r = f12_mul_h(ah, _h(b))
    elif op == "mul_by_034":
        bh = mont.to_halves(b.reshape(3, 16, *b.shape[1:]).movedim(1, 0))  # (32, 3, *b)
        r = f12_mul_by_034_h(ah, bh[:, 0], bh[:, 1], bh[:, 2])
    else:
        r = {"sq": f12_sq_h, "inv": f12_inv_h, "conj": f12_conj_h,
             "frobenius": lambda x: f12_frobenius_h(x, power)}[op](ah)
    return _w(r)


def f12_map(op: str, a, b=None, power: int = 0, route: str | None = None):
    """P3: one tower op (a key of OPS) over the lanes of a (96, *batch); b:
    the second operand (96, *batch) of "mul", the line (48, *batch) of
    "mul_by_034"; power: frobenius's. `route`: "schedule" or "thread", by
    default `p3_route`'s."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}: one of {list(OPS)}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown route {route!r}: one of {list(ROUTES)}")
    if (b is None) != (op not in ("mul", "mul_by_034")):
        raise ValueError(f"{op} takes {'a second operand' if b is None else 'one operand'}")
    _check_fq12(a)
    if b is not None:
        _check_fq12(b, 48 if op == "mul_by_034" else 96)
        if b.shape[1:] != a.shape[1:]:
            raise ValueError(f"operand batches {tuple(a.shape[1:])} and {tuple(b.shape[1:])} differ")
    if not _on_card(*([a] if b is None else [a, b])):
        return map_plain(op, a, b, power)
    n = a[0].numel()
    a2 = a.reshape(a.shape[0], n).contiguous()
    b2 = a2 if b is None else b.reshape(b.shape[0], n).contiguous()
    out = torch.empty_like(a2)
    if n:
        route = route or p3_route(op, n)
        if route == "schedule":
            sched = schedule.f12_op(op, power)
            _launch("f12_map", a.device, "f12_sched", _schedule_table(a.device, sched), a2, b2,
                    sched.smem_bytes(), out, n)
        else:
            _launch("f12_map", a.device, "f12_map", OPS[op], a2, b2, frobenius_table(a.device),
                    power % 12, out, n)
        ROUTE_LAUNCHES[route] += 1
    return out.reshape(a.shape)


def f12_mul(a, b):
    """P3. a * b over (96, *batch) lanes."""
    return f12_map("mul", a, b)


def f12_sq(a):
    return f12_map("sq", a)


def f12_inv(a):
    """a^-1 (0 maps to 0)."""
    return f12_map("inv", a)


def f12_conj(a):
    """x -> x^(q^6): c1 negated, the inverse on the cyclotomic subgroup."""
    return f12_map("conj", a)


def f12_frobenius(a, power: int):
    return f12_map("frobenius", a, power=power)


def f12_mul_by_034(a, c):
    """a * (c0, 0, 0, c3, c4, 0); c (48, *batch): c0, c3, c4, 16 words each."""
    return f12_map("mul_by_034", a, c)


def _schedule_table(device, sched):
    return _on(device, f"schedule {sched.name} {sched.n_lines()}", lambda: torch.from_numpy(sched.table))


def pair_threads() -> int:
    """The block size P1 and P2 launch with (csrc/pairing.cu `kPairT`)."""
    return _build.lib().kt_pair_threads()


def miller_loop_coeffs(coeffs):
    """P1 on encoded line coefficients (n_folds, n_pairs, 3, 16) -> (96,)."""
    if coeffs.dim() != 4 or coeffs.shape[0] != N_FOLDS or coeffs.shape[2:] != (3, 16) or coeffs.shape[1] < 1:
        raise ValueError(f"expected ({N_FOLDS}, n_pairs, 3, 16) words, got {tuple(coeffs.shape)}")
    if not _on_card(coeffs):
        return miller_loop_plain(coeffs)
    sched = schedule.miller_loop(coeffs.shape[1])
    coeffs = coeffs.contiguous()
    out = torch.empty(96, dtype=torch.int32, device=coeffs.device)
    _launch("pair_miller_loop", coeffs.device, "pair_miller_loop", _schedule_table(coeffs.device, sched),
            coeffs, sched.n_lines(), sched.smem_bytes(), out)
    return out


def multi_miller_loop_device(pairs, device=None):
    """The Miller loop of prod e(P_i, Q_i): pairs of (pyref G1 affine,
    G2Prepared) as `pyref.pairing_fast.multi_miller_loop` takes them;
    identity pairs are skipped, and with none live the result is one.
    (96,) words on `device` (None: the card)."""
    device = resolve(device)
    live = [(p, q) for p, q in pairs if not p.is_infinity and not q.is_infinity]
    if not live:
        return f12_one_words(device)
    return miller_loop_coeffs(_encode_prepared(live, device))


def final_exp_device(f):
    """P2. f^((q^12 - 1) / r): (96,) words -> (96,)."""
    if f.shape != (96,):
        raise ValueError(f"expected (96,) words, got {tuple(f.shape)}")
    if not _on_card(f):
        return final_exp_plain(f)
    sched = schedule.final_exp()
    out = torch.empty(96, dtype=torch.int32, device=f.device)
    _launch("pair_final_exp", f.device, "pair_final_exp", _schedule_table(f.device, sched), f.contiguous(),
            sched.smem_bytes(), out)
    return out


def pairing_device(p, q, device=None):
    """e(p, q) from pyref affine points (G1, G2): (96,) words on `device`."""
    return final_exp_device(multi_miller_loop_device([(p, G2Prepared.from_affine(q))], device))


def gt_eq_device(f, target) -> bool:
    """f == target in the target group, decided on f's device: f *
    conj(target) (Gt's f - target; the conjugate is the inverse there) is
    compared with one. f: (96,) words; target: a pyref Fq12 in Gt."""
    t = encode_fq12(target, f.device)
    d = f12_mul(f, f12_conj(t))
    return bool(torch.equal(d, f12_one_words(d.device)))


# ---------------------------------------------------------------------------
# the least time the card could take for a kernel call (chip_smoke.py)
# ---------------------------------------------------------------------------

_INV_FQ = 256 + bin(FQ.p - 2).count("1")  # fp_inv: a square per bit, a multiply per set bit
# Fq multiplies each tower op needs (an Fq2 multiply is 3, a square 2), as
# csrc/pairing.cu's one-thread code and the schedules make them; frobenius 5
# Fq2 products by constants, c1 w and c2 w formed on the host as the
# schedules take them (the one-thread code makes those two products itself:
# 21)
MULS = {
    "mul": 54, "sq": 36, "mul_by_034": 39, "frobenius": 15, "conj": 0,
    "inv": 36 + (6 + 9 + 9 + 9 + 4 + _INV_FQ) + 36,  # f6 squares, f6_inv, f6 products
}


def kernel_muls(kernel: str, n_pairs: int = 1, op: str = "mul", lanes: int = 1) -> int:
    """Fq multiplies of one call on one thread: P1 over n_pairs, P2 (the easy
    part, a square per bit but the last, a multiply per set bit), P3 `op`
    over lanes."""
    if kernel == "pair_miller_loop":
        return N_SQUARES * MULS["sq"] + N_FOLDS * n_pairs * MULS["mul_by_034"]
    if kernel == "pair_final_exp":
        easy = MULS["inv"] + 2 * MULS["mul"] + MULS["frobenius"]
        return easy + (len(_HARD_BITS) - 1) * MULS["sq"] + int(_HARD_BITS.sum()) * MULS["mul"]
    return MULS[op] * lanes


def _schedule(kernel: str, n_pairs: int = 1, op: str = "mul", power: int = 0):
    if kernel == "pair_miller_loop":
        return schedule.miller_loop(n_pairs)
    if kernel == "pair_final_exp":
        return schedule.final_exp()
    return schedule.f12_op(op, power)


def schedule_muls(kernel: str, n_pairs: int = 1) -> int:
    """Fq multiplies P1's or P2's schedule makes: its products, plus each
    Fermat inverse's chain."""
    sched = _schedule(kernel, n_pairs)
    return sched.products() + sched.depth()[1] * _INV_FQ


def bound_ms(kernel: str, sm_clock_hz: float, n_pairs: int = 1, op: str = "mul", lanes: int = 1):
    """(ms, "operations" | "bytes"): the larger of the time for the 32-bit
    multiply-adds (ec.MULADD_PER_MUL per Fq multiply, at 64 per SM per clock
    on 132 SMs; P1's and P2's multiplies are their schedules', P3's
    `kernel_muls`) and the time to read each input and write each output once
    at 3.35 TB/s. P1 reads its flags and coefficients, P2 its Fq12, the
    frobenius table and the exponent's bits, P3 its operands."""
    muls = kernel_muls(kernel, op=op, lanes=lanes) if kernel == "f12_map" else schedule_muls(kernel, n_pairs)
    t_ops = muls * ec.MULADD_PER_MUL / (ec.H100_SMS * ec.MULADD_PER_SM_CLOCK * sm_clock_hz) * 1e3
    fq12 = 96 * 4
    if kernel == "pair_miller_loop":
        n_bytes = N_FOLDS * 4 + N_FOLDS * n_pairs * 48 * 4 + fq12
    elif kernel == "pair_final_exp":
        n_bytes = 2 * fq12 + 12 * 48 * 4 + len(_HARD_BITS) * 4
    else:
        second = {"mul": fq12, "mul_by_034": 48 * 4}.get(op, 0)
        n_bytes = lanes * (2 * fq12 + second)
    t_bytes = n_bytes / ec.H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def one_thread_floor_ms(kernel: str, mul_cycles: float, sm_clock_hz: float, launch_ms: float,
                        n_pairs: int = 1):
    """P1's or P2's critical-path floor on one thread: each Fq multiply
    after the one before, at `mul_cycles` (one dependent multiply through
    fp_mul_call, csrc/imad_probe.cu), plus an empty launch. No design that
    runs the product on one thread can beat it."""
    return kernel_muls(kernel, n_pairs) * mul_cycles / sm_clock_hz * 1e3 + launch_ms


def depth_levels(kernel: str, n_pairs: int = 1, op: str = "mul", power: int = 0) -> tuple:
    """(levels of products, Fermat inverses) P1's, P2's or P3's `op` schedule
    (its schedule route) runs one after another."""
    return _schedule(kernel, n_pairs, op, power).depth()


def depth_floor_ms(kernel: str, mul_cycles: float, call_cycles: float, sm_clock_hz: float,
                   launch_ms: float, n_pairs: int = 1, op: str = "mul"):
    """P1's, P2's or P3's `op` (on its schedule route) critical-path floor on
    a block: its schedule's levels of products, each at least one dependent
    inline multiply (`mul_cycles`), plus each Fermat inverse's chain on one
    thread (_INV_FQ multiplies through fp_mul_call, `call_cycles` each), plus
    an empty launch."""
    levels, inverses = depth_levels(kernel, n_pairs, op)
    return (levels * mul_cycles + inverses * _INV_FQ * call_cycles) / sm_clock_hz * 1e3 + launch_ms
