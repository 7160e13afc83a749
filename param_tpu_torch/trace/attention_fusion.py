"""Attention-window detection in PyTorch-ET op streams, for the op
replay's ``--fuse attention`` what-if (the port's
``param_tpu/trace/attention_fusion.py``).

A PyTorch trace records attention unfused, e.g. GPT-2's eager attention:

    aten::transpose (k)        -> (B, H, D, S)
    aten::matmul   (q @ kT)    -> (B, H, S, S)
    aten::full / aten::div     scores / sqrt(d)
    aten::slice x4, aten::full causal-bias slab + mask value
    aten::where                mask
    aten::softmax
    aten::to, aten::dropout
    aten::matmul  (probs @ v)  -> (B, H, S, D)

This pass finds those windows by dataflow: anchored at each softmax, it
walks producers back to the q @ kT matmul and consumers forward to the
probs @ v matmul through cast / dropout pass-throughs.  The replayer then
runs one fused flash-attention call a window
(:func:`param_tpu_torch.ops.attention.flash_attention`, K6 on the card),
and, for ``attention-train``, one ``flash_attention_bwd`` (K7) a backward
window.  Pure matching on :class:`PtNode`; the windows equal the JAX
package's on the same trace.

PARAM's replayer has no analogue: it rebuilds each recorded op verbatim
(``et_replay.py:829`` ``build_func``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from param_tpu_torch.trace.pytorch_et import PtNode, is_tensor_slot, tensor_key

# ops that forward their first tensor input value-unchanged (eval-mode
# dropout included: the replayer's aten::dropout is identity)
_PASS = {"aten::to", "aten::_to_copy", "aten::contiguous", "aten::clone",
         "aten::detach", "aten::dropout"}
_MATMUL = {"aten::matmul", "aten::bmm"}


@dataclass
class AttnWindow:
    """One fusable attention subgraph: replay skips ``skip_ids`` and emits
    flash_attention(q, k, v) at the anchor (the probs @ v matmul)."""

    anchor_id: int
    skip_ids: set
    q: Tuple[Any, Tuple[int, ...], str]  # (desc, shape, type_token)
    k: Tuple[Any, Tuple[int, ...], str]
    v: Tuple[Any, Tuple[int, ...], str]
    scale: float
    causal: bool
    shape: Tuple[int, int, int, int] = field(default=())  # B, H, S, D
    # causal=True is an ASSUMPTION: the trace records an aten::where whose
    # mask VALUES are not in the trace (GPT2's is a sliced causal-bias
    # buffer; a padding mask would record the same ops).  Surfaced in the
    # replay report so what-if numbers are read with that caveat.
    mask_assumed: bool = False


def _tensor_slots(node: PtNode):
    out = []
    for i, tok in enumerate(node.input_types):
        if is_tensor_slot(tok) and i < len(node.inputs):
            out.append((i, node.inputs[i], tok,
                        tuple(int(d) for d in (node.input_shapes[i] or []))))
    return out


def _swaps_last_two(node: PtNode) -> bool:
    """transpose(-1, -2)/(d-1, d-2) or a permute ending ..., d-1, d-2."""
    rank = len(node.input_shapes[0] or [])
    lits = [x for x in node.inputs[1:] if isinstance(x, int)]
    if node.name == "aten::transpose" and len(lits) >= 2:
        a, b = lits[0] % rank, lits[1] % rank
        return {a, b} == {rank - 2, rank - 1}
    if node.name == "aten::permute":
        perm = node.inputs[1] if len(node.inputs) > 1 else None
        if isinstance(perm, (list, tuple)) and len(perm) == rank:
            want = list(range(rank - 2)) + [rank - 1, rank - 2]
            return [p % rank for p in perm] == want
    return False


def find_attention_windows(nodes: List[PtNode]) -> List[AttnWindow]:
    """Match fusable attention windows in an op stream (see module doc).

    Conservative: every intermediate tensor must have exactly one
    consumer inside the window, q/k/v must be rank-4 (B, H, S, D) with a
    transposed-K matmul, and the scale must be a literal or an
    ``aten::full`` constant.  Unmatched softmaxes are left alone."""
    prod: Dict[Tuple[int, int], List[PtNode]] = {}
    cons: Dict[Tuple[int, int], List[PtNode]] = {}
    for n in nodes:
        for i, tok in enumerate(n.output_types):
            if is_tensor_slot(tok) and i < len(n.outputs):
                key = tensor_key(n.outputs[i])
                if key is not None:
                    prod.setdefault(key, []).append(n)
        for _, desc, tok, _s in _tensor_slots(n):
            key = tensor_key(desc)
            if key is not None:
                cons.setdefault(key, []).append(n)

    def producer_before(key, nid: int) -> Optional[PtNode]:
        """Latest producer of ``key`` earlier in the stream than node
        ``nid`` — in-place ops reuse tensor keys, so the producer must be
        resolved against stream order (ids strictly decrease along the
        walk, which also makes cycles impossible)."""
        best = None
        for cand in prod.get(key, ()):
            if cand.id < nid and (best is None or cand.id > best.id):
                best = cand
        return best

    def back(desc, from_node: PtNode, skip: set) -> Optional[PtNode]:
        """Walk producers through pass-through ops, collecting them."""
        p = producer_before(tensor_key(desc), from_node.id)
        while p is not None and p.name in _PASS:
            skip.add(p.id)
            slots = _tensor_slots(p)
            if not slots:
                return None
            p = producer_before(tensor_key(slots[0][1]), p.id)
        return p

    windows: List[AttnWindow] = []
    claimed: set = set()
    for s_node in nodes:
        if s_node.name not in ("aten::softmax", "aten::_softmax"):
            continue
        if s_node.id in claimed:
            continue
        skip = {s_node.id}
        slots = _tensor_slots(s_node)
        if not slots:
            continue

        # ---- backward: softmax <- [where] <- [div|mul] <- matmul(q, kT)
        p = back(slots[0][1], s_node, skip)
        causal = False
        if p is not None and p.name == "aten::where":
            causal = True
            skip.add(p.id)
            wslots = _tensor_slots(p)
            if len(wslots) < 2:
                continue
            p = back(wslots[1][1], p, skip)  # where(cond, scores, fill)
        scale = None
        if p is not None and p.name in ("aten::div", "aten::mul"):
            op = p
            skip.add(op.id)
            oslots = _tensor_slots(op)
            val = None
            if len(oslots) >= 2:  # scalar as a full() tensor
                sp = producer_before(tensor_key(oslots[1][1]), op.id)
                if sp is not None and sp.name == "aten::full" \
                        and len(sp.inputs) > 1 \
                        and isinstance(sp.inputs[1], (int, float)):
                    val = float(sp.inputs[1])
            elif len(op.inputs) > 1 and isinstance(
                    op.inputs[1], (int, float)):  # literal scalar
                val = float(op.inputs[1])
            if val is None or val == 0.0:
                continue
            scale = (1.0 / val) if op.name == "aten::div" else val
            p = back(oslots[0][1], op, skip)
        m1 = p
        if m1 is None or m1.name not in _MATMUL:
            continue
        m1_slots = _tensor_slots(m1)
        if len(m1_slots) < 2:
            continue
        q_slot = m1_slots[0]
        kt = back(m1_slots[1][1], m1, skip)
        if kt is None or kt.name not in ("aten::transpose", "aten::permute") \
                or not _swaps_last_two(kt):
            continue
        k_slot = _tensor_slots(kt)[0]
        skip.update({m1.id, kt.id})

        # ---- forward: softmax -> [to/dropout]* -> matmul(probs, v)
        cur = s_node
        m2 = None
        fwd_ids = []
        for _hop in range(6):
            outs = [o for i, o in enumerate(cur.outputs)
                    if i < len(cur.output_types)
                    and is_tensor_slot(cur.output_types[i])]
            if not outs:
                break
            users = cons.get(tensor_key(outs[0]), [])
            users = [u for u in users if u.id > cur.id]
            if not users:
                break
            # follow the NEAREST consumer; later consumers (e.g. the
            # backward pass reusing saved activations) are allowed — they
            # rematerialize from metadata, which is fine for cost replay
            nxt = min(users, key=lambda u: u.id)
            if nxt.name in _PASS:
                fwd_ids.append(nxt.id)
                cur = nxt
                continue
            if nxt.name in _MATMUL:
                nslots = _tensor_slots(nxt)
                if len(nslots) >= 2 and tensor_key(nslots[0][1]) == \
                        tensor_key(outs[0]):
                    m2 = nxt
            break
        if m2 is None:
            continue
        v_slot = _tensor_slots(m2)[1]

        q_shape, k_shape, v_shape = q_slot[3], k_slot[3], v_slot[3]
        if not (len(q_shape) == len(k_shape) == len(v_shape) == 4):
            continue
        b, h, sq, d = q_shape
        if k_shape[:2] != (b, h) or k_shape[3] != d or v_shape != k_shape:
            continue
        if causal and sq > k_shape[2]:
            continue  # flash causal needs S_q <= S_k
        skip.update(fwd_ids)
        skip.add(m2.id)
        windows.append(AttnWindow(
            anchor_id=m2.id, skip_ids=skip,
            q=(q_slot[1], q_shape, q_slot[2]),
            k=(k_slot[1], k_shape, k_slot[2]),
            v=(v_slot[1], v_shape, v_slot[2]),
            # no div/mul in the recorded stream = the model scaled q
            # upstream; the fused op must NOT rescale
            scale=scale if scale is not None else 1.0,
            causal=causal, shape=(b, h, sq, d),
            mask_assumed=causal))
        claimed.update(skip)
    return windows


# --------------------------------------------------------------------------
# Backward windows
# --------------------------------------------------------------------------
# A recorded training iteration carries the attention BACKWARD unfused too
# (autograd's decomposition, verified against a torch
# ExecutionTraceObserver fwd+bwd trace of the eager GPT2 attention):
#
#     bmm(probs^T, dO)            -> dV            (B*H, S, D)
#     bmm(dO, v^T)                -> dP            (B*H, S, S)
#     aten::_softmax_backward_data(dP, probs)      (B, H, S, S)
#     aten::where x2 / aten::to   mask backward    (causal)
#     aten::div                   scale backward
#     bmm(q^T, dS)                -> dK^T          (B*H, D, S)
#     bmm(dS, k)                  -> dQ            (B*H, S, D)
#
# i.e. four S^2 matmuls plus three S^2 elementwise ops per head — the
# traffic flash_attention_bwd (ops/attention.py) removes.  The matcher
# anchors at _softmax_backward_data and walks the same dataflow.

# value-forwarding ops in backward walks (reshape/view change shape but
# forward the tensor; resolve_conj is identity on real dtypes; dropout
# backward forwards grad x mask — an S^2 elementwise op the fused kernel
# absorbs, like dropout itself in the forward window)
_BPASS = _PASS | {"aten::view", "aten::reshape", "aten::_reshape_alias",
                  "aten::resolve_conj", "aten::native_dropout_backward",
                  "aten::dropout_backward"}
# elementwise S^2 ops consumed into the fused backward
_BCHAIN = _BPASS | {"aten::where", "aten::div", "aten::mul"}


@dataclass
class AttnBwdWindow:
    """One fusable attention-backward subgraph: replay skips ``skip_ids``
    and emits flash_attention_bwd(q, k, v, o, lse, dO) at the anchor (the
    last of the dQ/dK^T matmuls in stream order).  ``outs`` maps each
    replaced matmul's output to the fused result that stands in for it:
    (node_id, out_desc, out_shape, kind) with kind in dq|dkT|dv."""

    anchor_id: int
    skip_ids: set
    q: Tuple[Any, Tuple[int, ...], str, bool]  # (desc, shape, tok, needs_T)
    k: Tuple[Any, Tuple[int, ...], str, bool]
    v: Tuple[Any, Tuple[int, ...], str, bool]
    do: Tuple[Any, Tuple[int, ...], str, bool]
    outs: List[Tuple[int, Any, Tuple[int, ...], str]]
    scale: float
    causal: bool
    shape: Tuple[int, int, int, int, int] = field(default=())  # B,H,Sq,Sk,D
    index: int = 0  # window ordinal (keys the synthesized o/lse inputs)
    mask_assumed: bool = False  # see AttnWindow.mask_assumed


def find_attention_bwd_windows(nodes: List[PtNode]) -> List[AttnBwdWindow]:
    """Match fusable attention-backward windows (see block comment)."""
    prod: Dict[Tuple[int, int], List[PtNode]] = {}
    cons: Dict[Tuple[int, int], List[PtNode]] = {}
    for n in nodes:
        for i, tok in enumerate(n.output_types):
            if is_tensor_slot(tok) and i < len(n.outputs):
                key = tensor_key(n.outputs[i])
                if key is not None:
                    prod.setdefault(key, []).append(n)
        for _, desc, tok, _s in _tensor_slots(n):
            key = tensor_key(desc)
            if key is not None:
                cons.setdefault(key, []).append(n)

    def producer_before(key, nid: int) -> Optional[PtNode]:
        best = None
        for cand in prod.get(key, ()):
            if cand.id < nid and (best is None or cand.id > best.id):
                best = cand
        return best

    def back(desc, from_node: PtNode, skip: set) -> Optional[PtNode]:
        p = producer_before(tensor_key(desc), from_node.id)
        while p is not None and p.name in _BPASS:
            skip.add(p.id)
            slots = _tensor_slots(p)
            if not slots:
                return None
            p = producer_before(tensor_key(slots[0][1]), p.id)
        return p

    def operand(mm: PtNode, slot_i: int, skip: set):
        """Resolve matmul operand ``slot_i`` to (desc, shape, tok, needs_T):
        if its producer is a last-two-swap transpose, return the
        pre-transpose tensor with needs_T set (and skip the transpose)."""
        slots = _tensor_slots(mm)
        i, desc, tok, shape = slots[slot_i]
        p = producer_before(tensor_key(desc), mm.id)
        seen_pass = []
        while p is not None and p.name in _BPASS:
            seen_pass.append(p.id)
            ps = _tensor_slots(p)
            if not ps:
                p = None
                break
            desc2 = ps[0][1]
            p = producer_before(tensor_key(desc2), p.id)
        if p is not None and p.name in ("aten::transpose", "aten::permute") \
                and _swaps_last_two(p):
            skip.update(seen_pass)
            skip.add(p.id)
            ts = _tensor_slots(p)
            return (ts[0][1], ts[0][3], ts[0][2], True)
        return (desc, shape, tok, False)

    def out_key(n: PtNode):
        for i, tok in enumerate(n.output_types):
            if is_tensor_slot(tok) and i < len(n.outputs):
                return tensor_key(n.outputs[i])
        return None

    def first_out(n: PtNode):
        for i, tok in enumerate(n.output_types):
            if is_tensor_slot(tok) and i < len(n.outputs):
                return (n.outputs[i],
                        tuple(int(d) for d in (n.output_shapes[i] or [])))
        return None

    windows: List[AttnBwdWindow] = []
    claimed: set = set()
    for a in nodes:
        if a.name != "aten::_softmax_backward_data":
            continue
        if a.id in claimed:
            continue
        skip = {a.id}
        slots = _tensor_slots(a)
        if len(slots) < 2:
            continue
        dp_shape = slots[0][3]
        if len(dp_shape) == 4:
            b, h, sq, sk = dp_shape
        elif len(dp_shape) == 3:
            b, (h, sq, sk) = 1, dp_shape
        else:
            continue

        # ---- producers: dP = bmm(dO, v^T); sibling dV = bmm(probs^T, dO)
        m_dp = back(slots[0][1], a, skip)
        if m_dp is None or m_dp.name not in _MATMUL:
            continue
        dp_slots = _tensor_slots(m_dp)
        if len(dp_slots) < 2:
            continue
        do_slot = (dp_slots[0][1], dp_slots[0][3], dp_slots[0][2], False)
        v_slot = operand(m_dp, 1, skip)
        if not v_slot[3]:
            continue  # dP needs a transposed V
        # operand() recovered the PRE-transpose tensor, already (Sk, D)
        v_slot = v_slot[:3] + (False,)
        skip.add(m_dp.id)
        d = do_slot[1][-1]

        m_dv = None
        for u in cons.get(tensor_key(do_slot[0]), ()):
            if u.name in _MATMUL and u.id != m_dp.id \
                    and abs(u.id - m_dp.id) < 40:
                m_dv = u
                break
        if m_dv is None:
            continue
        # its other operand must be a transposed probs
        dv_slot_i = 0 if tensor_key(_tensor_slots(m_dv)[1][1]) == \
            tensor_key(do_slot[0]) else 1
        pt = operand(m_dv, dv_slot_i, skip)
        if not pt[3]:
            continue
        skip.add(m_dv.id)
        dv_out = first_out(m_dv)

        # ---- consumers: [where/to]* -> div -> dQ/dK^T matmuls.  The walk
        # follows the NEAREST consumer in stream order (storage keys get
        # reused across the graph, so a pure key-set walk can jump over the
        # div straight into a later reuser of the same storage).
        cur = a
        key = out_key(a)
        causal = False
        scale = None
        mms: List[PtNode] = []
        for _hop in range(10):
            users = [u for u in cons.get(key, ())
                     if u.id > cur.id and u.id not in skip]
            if not users:
                break
            nxt = min(users, key=lambda u: u.id)
            if nxt.name in _MATMUL:
                # both grad matmuls consume dS back-to-back; the id window
                # guards against later reusers of a recycled storage key
                mms = [u for u in users if u.name in _MATMUL
                       and u.id - nxt.id < 40]
                break
            if nxt.name not in _BCHAIN:
                break
            skip.add(nxt.id)
            if nxt.name == "aten::where":
                causal = True
            if nxt.name in ("aten::div", "aten::mul"):
                us = _tensor_slots(nxt)
                val = None
                if len(us) >= 2:
                    sp = producer_before(tensor_key(us[1][1]), nxt.id)
                    if sp is not None and sp.name == "aten::full" \
                            and len(sp.inputs) > 1 \
                            and isinstance(sp.inputs[1], (int, float)):
                        val = float(sp.inputs[1])
                elif len(nxt.inputs) > 1 and isinstance(
                        nxt.inputs[1], (int, float)):
                    val = float(nxt.inputs[1])
                if val:
                    scale = (1.0 / val) if nxt.name == "aten::div" else val
            ok = out_key(nxt)
            if ok is None:
                break
            cur, key = nxt, ok
        if len(mms) != 2:
            continue

        q_slot = k_slot = None
        dq_out = dkt_out = None
        ds_key = key
        good = True
        for mm in mms:
            ms = _tensor_slots(mm)
            if len(ms) < 2:
                good = False
                break
            if tensor_key(ms[0][1]) == ds_key:      # dQ = dS @ K
                k_slot = operand(mm, 1, skip)
                # a transposed K operand means the SAVED tensor is K^T
                # (the model cached k pre-transposed) — swap at emission
                dq_out = (mm.id,) + first_out(mm) + ("dq",)
            elif tensor_key(ms[1][1]) == ds_key:    # dK^T = Q^T @ dS
                q_slot = operand(mm, 0, skip)
                if not q_slot[3]:
                    good = False
                    break
                # pre-transpose tensor is Q itself, already (Sq, D)
                q_slot = q_slot[:3] + (False,)
                dkt_out = (mm.id,) + first_out(mm) + ("dkT",)
            skip.add(mm.id)
        if not good or q_slot is None or k_slot is None:
            continue
        if causal and sq > sk:
            continue

        windows.append(AttnBwdWindow(
            anchor_id=max(m.id for m in mms), skip_ids=skip,
            q=q_slot, k=k_slot, v=v_slot, do=do_slot,
            outs=[o for o in [
                (m_dv.id,) + dv_out + ("dv",), dq_out, dkt_out]
                if o is not None],
            scale=scale if scale is not None else 1.0,
            causal=causal, shape=(b, h, sq, sk, d),
            index=len(windows), mask_assumed=causal))
        claimed.update(skip)
    return windows
