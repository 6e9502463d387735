"""One agent's local step split over its agent block: the counterpart of the
reference's ``param_shardings`` route (``repro/launch/dryrun.py:
build_train_panel``, ``repro/core/dsgd.py:make_panel_segment``), for the
GQA decoders: the dense ones (olmo-1b, phi3-mini-3.8b, yi-34b, gemma-2b,
gemma-2b-sw), arctic-480b (its MoE FFN: 128 experts top-2 beside a dense
MLP) and qwen2-vl-72b (M-RoPE, the patch prefix).

The ranks that hold one agent's rows (its *agent block*: the mesh's ``fsdp``
x ``model`` lines, ``launch/mesh.py``) share its step:

* its batch rows over ``fsdp``: fsdp rank f differentiates rows [f b / F,
  (f + 1) b / F) of the agent's b; the loss stays the mean over the whole
  batch's masked tokens (the token count summed over ``fsdp`` before the
  division), and the shares' gradients are summed;
* its heads, d_ff columns and vocabulary over ``model`` (tensor
  parallelism, Megatron's column / row pairs): model rank j computes the
  query heads [j H / M, (j + 1) H / M) (``wq``'s columns, ``wo``'s rows),
  the kv heads [j Kv / M, ...) where M divides Kv, the d_ff columns of
  ``w_in``/``w_gate`` and rows of ``w_out``, and the vocabulary's rows [j V
  / M, ...) of the head (``head.w``'s columns, or the tied table's rows).
  A split block is entered through :meth:`Split.copy_in` (identity forward,
  all-reduce of the gradient over ``model``) and left through
  :meth:`Split.reduce_out` (all-reduce forward, identity backward); the
  head's logsumexp and target logit are taken over ``model``
  (:meth:`Split.vocab_nll`);
* an MoE block's experts over ``model`` (``models/moe.py``): model rank j
  holds experts [j E / M, (j + 1) E / M) of the banks (the ``expert``
  logical dim, -3), the router runs whole on every rank and each rank
  dispatches to its own experts; the combined output is a part, summed
  over ``model`` with the ``dense`` / ``shared`` MLPs' parts (split on
  their own widths) in one ``reduce_out``. The capacity rule is the
  agent's whole batch's: C of the whole batch's tokens, and each
  assignment's rank within its expert its place in the whole batch's
  (token, slot) order (an exclusive prefix over ``fsdp`` of the experts'
  counts), so the ranks keep exactly the assignments one process keeps.
  The load-balance aux reads counts and probabilities summed over
  ``fsdp``; its gradient passes on model rank 0 only.

Norms, RoPE (M-RoPE's three position rows too), the patch prefix (the
rank's rows of ``patch_embeds`` before the lookup's output) and the
embedding lookup run whole on every rank. A dim that
the model line does not divide stays whole on every model rank: the
reference's drop-on-indivisible rule (``models/sharding.py:resolve_leaf``)
at head granularity, e.g. gemma's one kv head at any M > 1 (every rank
reads it for its query heads), yi's and arctic's 56 heads and gemma's 8 at
M = 16 (the whole attention on every model rank), an expert bank whose E
the model line does not divide.

Each parameter leaf takes one of three gradient rules (:class:`LeafSplit`,
:func:`leaf_plan`): ``split`` (the rank's block along ``dim``), ``once``
(whole, its gradient the same on every model rank: written by model rank 0
only) or ``sum`` (whole, each model rank's gradient a part: summed; a
whole kv projection feeding split heads, the tied table, whose lookup
only model rank 0 differentiates and whose head rows each rank's, and the
router of split experts: the aux once, and each rank's combine part). The
model is told its line explicitly (``build_model(cfg, split=)``).

Serving (the reference's ``build_serve``, ``repro/launch/dryrun.py``): on
the production mesh (``launch.mesh.serve_shape``: the data axes on the
``fsdp`` line, ``model`` on ``model``) a rank holds each weight's block as
``model.param_spec()`` resolves under ``serve_rules(mesh, big)``
(:func:`serve_shardings`, :func:`serve_pieces`; ``big`` =
:func:`serve_big`: the fsdp dim over the data line too) and each KV cache
leaf's block as ``cache_spec()`` resolves (its rows over data, its kv
heads over model where M divides Kv). Before use, a layer at a time,
each leaf is gathered (:func:`materialize`, :func:`serve_plan`) over the
data line (big) and over the model line where the split decisions keep
it whole (``wq`` .. ``wo`` of an attention that stays whole, a kv head
shared by the rank's query heads, a d_ff or vocabulary that M does not
divide; an expert bank keeps its experts over model and is gathered over
the data line only), and freed after. The patch prefix is whole on every
rank and enters after the lookup's columns are gathered; M-RoPE's
positions count it. Each data rank's MoE blocks run dropless on its own
rows. The embedding table keeps its d_model columns
over model: the lookup gathers the rank's columns of the activations, a
tied head sums the ranks' partial logits over model; an untied head
computes the rank's vocabulary columns and gathers its float32 logits,
so every model rank holds the whole (B, padded_vocab) and samples the
same token. :meth:`Split.copy_in` / :meth:`Split.reduce_out` run without
a backward there (no autograd graph). Each data rank serves its own rows
(:meth:`Split.data_rows`: the caller cuts them); its model ranks run in
lockstep.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from repro_torch.models.sharding import TRAIN_RULES, resolve, serve_rules
from repro_torch.utils.tree import tree_flatten, tree_unflatten

# the families this route splits; any other family given param_shardings
# is refused by name (ROADMAP A16d)
SPLIT_FAMILIES = ("olmo-1b", "phi3-mini-3.8b", "yi-34b", "gemma-2b",
                  "gemma-2b-sw", "arctic-480b", "qwen2-vl-72b")


def unsplit_parts(cfg) -> List[str]:
    """What of ``cfg``'s model this route does not split (empty for the
    GQA decoders, their MoE FFN and M-RoPE with the patch prefix
    included): MLA, the recurrent mixers, blocks without the gated MLP or
    an MoE FFN, the encoder and cross attention, the MTP head."""
    out = []
    specs = list(cfg.layer_specs())
    if any(ls.mixer == "mla" for ls in specs):
        out.append("MLA attention")
    if any(ls.mixer in ("rglru", "mlstm", "slstm") for ls in specs):
        out.append("the recurrent mixers")
    if any(ls.ffn == "none" for ls in specs) or cfg.dense_ff_first_k:
        out.append("blocks without the gated MLP")
    if cfg.encoder_layers:
        out.append("the encoder and cross attention")
    if cfg.mtp_depth:
        out.append("the MTP head")
    return out


def check_family(cfg):
    """NotImplementedError, by name, for a model this route does not
    split."""
    parts = unsplit_parts(cfg)
    if parts:
        raise NotImplementedError(
            f"the split route: {cfg.name} has {', '.join(parts)}, which it "
            "does not split yet (ROADMAP A16d, its second item: the other "
            "families' split blocks); it splits the GQA decoders "
            f"{', '.join(SPLIT_FAMILIES)}, in training and serving")


class _CopyIn(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model line."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.model_sum(g.clone(
            memory_format=torch.contiguous_format)), None


class _ReduceOut(torch.autograd.Function):
    """All-reduce over a line (the model line, or fsdp) forward; identity
    backward."""

    @staticmethod
    def forward(ctx, y, split, line):
        return split._reduce(y.clone(memory_format=torch.contiguous_format),
                             line)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FirstRankGrad(torch.autograd.Function):
    """Identity forward; the gradient passes on model rank 0 only (none on
    the others). Every rank's graph keeps the same differentiable nodes,
    so every rank runs the same collectives in the backward pass."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.first = split.model_rank == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else None), None


class _VocabNll(torch.autograd.Function):
    """Per-position -log softmax(logits)[target] of a vocabulary split over
    the model line: ``lg`` (B, c, V / M) float32 the rank's columns, the
    rows [j V / M, (j + 1) V / M) of the vocabulary. The max, the sum of
    exponentials and the target's logit are taken over the line (one max,
    one sum of the two stacked); the gradient is the rank's columns of
    softmax - onehot."""

    @staticmethod
    def forward(ctx, lg, targets, split):
        n = lg.shape[-1]
        t = targets.long() - split.model_rank * n
        inside = (t >= 0) & (t < n)
        t = t.clamp(0, n - 1)
        mx = split.model_max(torch.amax(lg, dim=-1).contiguous())
        e = torch.exp(lg - mx[..., None])
        tgt = torch.where(inside, torch.gather(lg, -1, t[..., None])[..., 0],
                          torch.zeros((), dtype=lg.dtype, device=lg.device))
        st = split.model_sum(torch.stack([torch.sum(e, dim=-1), tgt]))
        nll = torch.log(st[0]) + mx - st[1]
        ctx.save_for_backward(e.div_(st[0][..., None]), t, inside)
        return nll

    @staticmethod
    def backward(ctx, g):
        p, t, inside = ctx.saved_tensors
        d = p * g[..., None]
        d.scatter_add_(-1, t[..., None], -(g * inside)[..., None])
        return d, None, None


@dataclass(frozen=True, eq=False)
class Split:
    """This rank's place in its agent block: ``mesh`` (``launch.mesh.Mesh``)
    gives the ``model`` and ``fsdp`` lines, their sizes M and F and the
    rank's coordinates j and f. The split decisions (:meth:`attn`,
    :meth:`kv`, :meth:`mlp`, :meth:`vocab`) hold where M > 1 divides the
    dim; the model layers and :func:`leaf_plan` both read them."""
    mesh: object

    @property
    def model_size(self) -> int:
        return len(self.mesh.members["model"])

    @property
    def model_rank(self) -> int:
        return self.mesh.coord["model"]

    @property
    def fsdp_size(self) -> int:
        return len(self.mesh.members["fsdp"])

    @property
    def fsdp_rank(self) -> int:
        return self.mesh.coord["fsdp"]

    # -- decisions ---------------------------------------------------------

    def attn(self, a) -> bool:
        """Whether the attention runs on the rank's H / M query heads: M
        divides H, and the kv heads either split too (M divides Kv) or each
        rank's query heads share one kv head (Kv divides M)."""
        M, H, Kv = self.model_size, a.num_heads, a.num_kv_heads
        return M > 1 and H % M == 0 and (Kv % M == 0 or M % Kv == 0)

    def kv(self, a) -> bool:
        """Whether ``wk``/``wv`` split by kv heads (else whole)."""
        return self.attn(a) and a.num_kv_heads % self.model_size == 0

    def local_heads(self, a):
        """(query heads, first kv head read, kv heads read) of this rank's
        split attention; kv heads counted in the projection's output (the
        rank's block where :meth:`kv`, else the whole Kv)."""
        M, H, Kv = self.model_size, a.num_heads, a.num_kv_heads
        if self.kv(a):
            return H // M, 0, Kv // M
        return H // M, self.model_rank * (H // M) // (H // Kv), 1

    def mlp(self, d_ff: int) -> bool:
        """Whether an MLP of width ``d_ff`` (the gated MLP's, or an MoE
        block's ``dense`` / ``shared`` MLP's own) splits its columns."""
        return self.model_size > 1 and d_ff > 0 and d_ff % self.model_size == 0

    def experts(self, E: int) -> bool:
        """Whether an MoE bank of E experts splits by experts."""
        return self.model_size > 1 and E % self.model_size == 0

    def expert_block(self, E: int):
        """(first expert, experts) of the rank's bank: [j E / M, (j + 1) E
        / M) where :meth:`experts` holds, else all E."""
        if not self.experts(E):
            return 0, E
        n = E // self.model_size
        return self.model_rank * n, n

    def vocab(self, V: int) -> bool:
        return self.model_size > 1 and V % self.model_size == 0

    def vocab_rows(self, V: int):
        n = V // self.model_size
        return self.model_rank * n, (self.model_rank + 1) * n

    def data_rows(self, b: int) -> slice:
        """A data rank's rows of a serving batch of ``b`` rows (the serve
        mesh's data line is its fsdp line): its block where the line
        divides ``b``, else every row (the batch then replicated over the
        data ranks, as ``resolve`` leaves an indivisible dim whole)."""
        D = self.fsdp_size
        if b % D:
            return slice(0, b)
        return slice(self.fsdp_rank * (b // D), (self.fsdp_rank + 1) * (b // D))

    def batch_rows(self, b: int) -> slice:
        """This rank's rows of an agent batch of ``b`` rows."""
        F = self.fsdp_size
        if b % F:
            raise ValueError(f"the split route shares an agent's batch of "
                             f"{b} rows over the {F} ranks of its fsdp line, "
                             f"and {F} does not divide {b}")
        n = b // F
        return slice(self.fsdp_rank * n, (self.fsdp_rank + 1) * n)

    # -- collectives -------------------------------------------------------

    def _reduce(self, x, line, op="sum"):
        if len(self.mesh.members[line]) == 1:
            return x
        return self.mesh.all_reduce(x, line, op=op)

    def model_sum(self, x):
        """``x`` summed over the model line, in place."""
        return self._reduce(x, "model")

    def model_max(self, x):
        return self._reduce(x, "model", op="max")

    def gather(self, x, axis, dim: int):
        """``x`` all-gathered over the line of mesh ``axis`` ('model', or
        'fsdp': the serve mesh's data line) along ``dim``, the ranks' blocks
        in line order."""
        line = _LINE_OF[axis]
        if len(self.mesh.members[line]) == 1:
            return x
        g = self.mesh.all_gather(x.movedim(dim, 0).contiguous(), line)
        return g.movedim(0, dim)

    def fsdp_sum(self, x):
        """``x`` summed over the fsdp line, in place."""
        return self._reduce(x, "fsdp")

    def block_sum(self, x):
        """``x`` summed over the agent block (fsdp x model), in place."""
        return self._reduce(x, "block")

    def copy_in(self, x):
        return _CopyIn.apply(x, self) if self.model_size > 1 else x

    def reduce_out(self, y):
        return _ReduceOut.apply(y, self, "model") if self.model_size > 1 \
            else y

    def fsdp_reduce_out(self, y):
        """``y`` summed over the fsdp line (a new tensor), the gradient
        passed through as it is: a sum over the agent's whole batch whose
        every fsdp rank differentiates its own rows' share."""
        return _ReduceOut.apply(y, self, "fsdp") if self.fsdp_size > 1 \
            else y

    def first_rank_grad(self, x):
        """``x``, differentiated on model rank 0 only: a whole input whose
        gradient every model rank would compute alike (the embedding
        lookup)."""
        return _FirstRankGrad.apply(x, self) if self.model_size > 1 else x

    def vocab_nll(self, lg, targets):
        return _VocabNll.apply(lg, targets, self)


@dataclass(frozen=True)
class LeafSplit:
    """A leaf's gradient rule on the split route: ``kind`` 'split' (the
    rank's block of ``dim``, M blocks), 'once' (whole, written by model
    rank 0) or 'sum' (whole, summed over the model line)."""
    kind: str
    dim: int = -1


# (parent key, leaf key) -> the leaf's role and the per-agent dim that the
# role splits, counted from the end; an MoE block's ``dense`` and
# ``shared`` MLPs split on their own widths
_ROLES = {("mixer", "wq"): ("q", -1), ("mixer", "wo"): ("q", -2),
          ("mixer", "wk"): ("kv", -1), ("mixer", "wv"): ("kv", -1),
          ("ffn", "w_in"): ("mlp", -1), ("ffn", "w_gate"): ("mlp", -1),
          ("ffn", "w_out"): ("mlp", -2), ("head", "w"): ("vocab", -1)}
for _mlp in ("dense", "shared"):
    _ROLES.update({(_mlp, "w_in"): (_mlp, -1), (_mlp, "w_gate"): (_mlp, -1),
                   (_mlp, "w_out"): (_mlp, -2)})
# an MoE block's leaves (its ``ffn`` holds a ``router``): the expert banks
# split on their expert dim, the router whole
_MOE_ROLES = {"w_in": ("expert", -3), "w_gate": ("expert", -3),
              "w_out": ("expert", -3), "router": ("router", None)}


def _paths(tree, at=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], at + (k,))
    else:
        yield at, tree


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _role(tree, path):
    """(role, dim) of the leaf at ``path`` of ``tree`` (a tree of the
    parameters' keys), or (None, None)."""
    if len(path) > 1 and path[-2] == "ffn" and "router" in _node(
            tree, path[:-1]):
        return _MOE_ROLES[path[-1]]
    return _ROLES.get(path[-2:], (None, None))


def _decisions(cfg, split: Split) -> Dict[str, bool]:
    """Each role's split decision on ``split``'s model line, each read on
    its leaf's own width."""
    a, V, m = cfg.attn, cfg.padded_vocab, cfg.moe
    take = {"q": split.attn(a), "kv": split.kv(a), "mlp": split.mlp(cfg.d_ff),
            "vocab": split.vocab(V), "router": False}
    if m is not None:
        take.update(expert=split.experts(m.num_experts),
                    dense=split.mlp(m.dense_ff), shared=split.mlp(m.shared_ff))
    return take


def leaf_plan(cfg, split: Split, param_shardings) -> Dict:
    """The tree of :class:`LeafSplit` of ``cfg``'s parameters on ``split``'s
    block. ``param_shardings`` is the resolved ``TRAIN_RULES`` tree of the
    agent-stacked parameters (:func:`train_shardings`, as the reference's
    ``build_train_panel`` builds it: the agent prefix first); a leaf that the
    split decisions split must carry 'model' on the dim they split
    (ValueError otherwise: the tree was resolved for another model line).
    The tied table splits for the head by rows whatever its entry (its
    lookup stays whole)."""
    check_family(cfg)
    take = _decisions(cfg, split)
    leaves = []
    for path, entry in _paths(param_shardings):
        role, dim = _role(param_shardings, path)
        if path == ("embed", "table"):
            rule = LeafSplit("sum" if cfg.tie_embeddings and take["vocab"]
                             else "once")
        elif role is not None and take[role]:
            per_agent = tuple(entry)[1:]
            d = len(per_agent) + dim
            if per_agent[d] != "model":
                raise ValueError(
                    f"param_shardings[{'.'.join(path)}] is {tuple(entry)}: "
                    f"the split route splits its dim {d} over the "
                    f"{split.model_size} model ranks, which it does not "
                    "name (resolve it with TRAIN_RULES on this mesh)")
            rule = LeafSplit("split", d)
        elif (role == "kv" and take["q"]) or (role == "router"
                                               and take["expert"]):
            rule = LeafSplit("sum")
        else:
            rule = LeafSplit("once")
        leaves.append(rule)
    return tree_unflatten(tree_flatten(param_shardings)[1], leaves)


def train_pieces(params, plan, split: Split):
    """The rank's pieces of one agent's whole ``params`` on the split route
    (``plan`` its :func:`leaf_plan`): a split leaf's block of the model
    line (a copy), the others as they are."""
    def one(_, x, rule):
        if rule.kind != "split":
            return x
        n = x.shape[rule.dim] // split.model_size
        return x.narrow(rule.dim, split.model_rank * n, n).clone(
            memory_format=torch.contiguous_format)
    return _map_paths(one, params, plan)


# the mesh lines a resolved serve entry gathers over
_LINE_OF = {"model": "model", "fsdp": "fsdp"}


def serve_big(cfg) -> bool:
    """The reference's ``big`` (``build_serve``): a model trained with
    fewer than 16 agents a pod (over 30 B parameters) has its weights' fsdp
    dim over the data axes too."""
    return cfg.dist.agents_per_pod < 16


@dataclass(frozen=True)
class ServeLeaf:
    """A parameter leaf on the serve route: ``entry`` its resolved
    ``serve_rules`` tuple (how a rank holds it), ``gathers`` the (axis,
    dim counted from the end) it is all-gathered over before use."""
    entry: tuple
    gathers: tuple


def _map_paths(fn, tree, *rest, at=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, tree[k], *(r[k] for r in rest),
                              at=at + (k,)) for k in tree}
    return fn(at, tree, *rest)


def serve_shardings(model, mesh):
    """The resolved ``serve_rules(mesh, serve_big(cfg))`` tree of
    ``model``'s parameters: the reference's ``build_serve`` params_ps, as
    tuples (shapes from the meta device; nothing allocated)."""
    check_family(model.cfg)
    one = model.init_params(None, torch.device("meta"))
    return resolve(model.param_spec(), one, mesh,
                   serve_rules(mesh, serve_big(model.cfg)))


def serve_plan(cfg, split: Split, shardings) -> Dict:
    """The tree of :class:`ServeLeaf` of ``cfg``'s parameters held as
    ``shardings`` resolves them: a dim over the data line is gathered; a
    dim over model is kept where the split decisions split it (the
    rank's heads, d_ff columns, experts and vocabulary; the table's
    d_model columns) and gathered where they keep the dim whole."""
    take = _decisions(cfg, split)

    def leaf(path, entry):
        role, rdim = _role(shardings, path)
        gathers = []
        for d, e in enumerate(entry):
            at = d - len(entry)
            if e is None:
                continue
            keep = e == "model" and (path == ("embed", "table") or (
                role is not None and take[role] and at == rdim))
            if not keep:
                gathers.append((e, at))
        return ServeLeaf(tuple(entry), tuple(gathers))

    return _map_paths(leaf, shardings)


def block_shape(shape, entry, mesh):
    """The shape of a rank's block of a leaf of ``shape`` held as
    ``entry``."""
    return tuple(n // (mesh.axis_size(e) if e is not None else 1)
                 for n, e in zip(shape, entry))


def rank_block(x, entry, mesh):
    """This rank's block of the whole leaf ``x`` held as ``entry``: each
    dim named by mesh axes cut to the rank's index along them (a copy)."""
    for d, (e, n) in enumerate(zip(entry, block_shape(x.shape, entry,
                                                      mesh))):
        if e is not None:
            x = x.narrow(d, mesh.axis_index(e) * n, n)
    return x.clone(memory_format=torch.contiguous_format)


def serve_pieces(params, mesh, shardings):
    """The rank's pieces of whole ``params`` (the serve route's
    counterpart of :func:`leaf_plan`): each leaf's block as ``shardings``
    (:func:`serve_shardings`) resolves it."""
    return _map_paths(lambda _, x, e: rank_block(x, e, mesh), params,
                      shardings)


def materialize(tree, plan, split: Split):
    """``tree``'s leaves (a block's, or one leaf) brought to the layout the
    computation reads: each gathered over the lines its :class:`ServeLeaf`
    names, a new tensor the caller drops after use."""
    def one(_, x, p):
        for axis, dim in p.gathers:
            x = split.gather(x, axis, dim)
        return x
    return _map_paths(one, tree, plan)


def describe(plan) -> Dict[str, List[str]]:
    """The leaves of ``plan`` by rule: {'split': ..., 'whole': ...,
    'summed': ...} as dotted paths (the records' and tests' names)."""
    out = {"split": [], "whole": [], "summed": []}
    for path, rule in _paths(plan):
        key = {"split": "split", "once": "whole", "sum": "summed"}[rule.kind]
        out[key].append(".".join(path))
    return out


def train_shardings(model, mesh, agents: int):
    """The resolved ``TRAIN_RULES`` tree of ``model``'s agent-stacked
    parameters on ``mesh`` with the ('pod', 'agent') prefix: the reference's
    ``build_train_panel`` param_shardings, as tuples (shapes from the meta
    device; nothing allocated)."""
    one = model.init_params(None, torch.device("meta"))
    stacked = tree_unflatten(tree_flatten(one)[1], [
        torch.empty((agents,) + tuple(x.shape), device="meta")
        for x in tree_flatten(one)[0]])
    return resolve(model.param_spec(), stacked, mesh, TRAIN_RULES,
                   prefix=(("pod", "agent"),))
