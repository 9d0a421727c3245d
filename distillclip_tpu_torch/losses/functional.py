"""Distillation losses as plain functions on tensors, all in fp32.

Port of ``distillclip_tpu/losses/functional.py``: every loss reproduces a
reference loss module with its exact torch reduction semantics, including the
quirks:

* :func:`kl_div_sum` mirrors ``nn.KLDivLoss(reduction='sum')``: a sum over all
  elements (so its size grows with the batch), with 0·log 0 = 0;
* per-layer losses average over the layer axis after the per-layer reduction
  (per-layer taps arrive stacked as ``[L, B, ...]``);
* :func:`last_value_map_kl` softmaxes over dim 1 (the head axis) of a map that
  was already softmaxed over the keys.
"""

from __future__ import annotations

import torch


def kl_div_sum(log_input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``nn.KLDivLoss(reduction='sum')``: Σ t · (log t − log_input), with
    0 · log 0 = 0."""
    log_input, target = log_input.float(), target.float()
    pos = target > 0
    t_log_t = torch.where(pos, target * torch.log(torch.where(pos, target, 1.0)), 0.0)
    return (t_log_t - target * log_input).sum()


def soft_cross_entropy_mean(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """Cross entropy with probability targets, mean over the batch."""
    logp = torch.log_softmax(logits.float(), dim=1)
    return -(target_probs.float() * logp).sum(dim=1).mean()


def cross_entropy_mean(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy with integer labels, mean reduction."""
    logp = torch.log_softmax(logits.float(), dim=1)
    return -logp.gather(1, labels[:, None])[:, 0].mean()


# -- output-level losses ---------------------------------------------------------

def out_l1(stu: torch.Tensor, tea: torch.Tensor) -> torch.Tensor:
    """L1 on last representations: mean |stu - tea|."""
    return (stu.float() - tea.float()).abs().mean()


def out_ce(stu: torch.Tensor, tea: torch.Tensor) -> torch.Tensor:
    """Soft-target cross entropy: CE(stu, softmax(tea))."""
    return soft_cross_entropy_mean(stu, torch.softmax(tea.float(), dim=1))


def out_kl(stu: torch.Tensor, tea: torch.Tensor, temperature: float) -> torch.Tensor:
    """KL(log_softmax(s/T), softmax(t/T)) · T², sum reduction."""
    logp = torch.log_softmax(stu.float() / temperature, dim=1)
    q = torch.softmax(tea.float() / temperature, dim=1)
    return kl_div_sum(logp, q) * temperature ** 2


def out_cos(stu: torch.Tensor, tea: torch.Tensor) -> torch.Tensor:
    """CosineEmbeddingLoss with target +1: mean(1 - cos), with the 1e-8
    added to the product of the norms."""
    s, t = stu.float(), tea.float()
    cos = (s * t).sum(dim=1) / (s.norm(dim=1) * t.norm(dim=1) + 1e-8)
    return (1.0 - cos).mean()


def embedding_mse(stu: torch.Tensor, tea: torch.Tensor) -> torch.Tensor:
    """MSE on the post-positional embeddings."""
    return (stu.float() - tea.float()).square().mean()


# -- per-layer feature losses (stacked [L, B, H, N, N] / [L, B, N, D]) ------------

def _head_mean(x: torch.Tensor) -> torch.Tensor:
    """``[L, B, H, N, N] -> [L, B, N, N]``: the sum over heads / the head count."""
    return x.float().sum(dim=2) / x.shape[2]


def attention_score_mse(stu_scores: torch.Tensor, tea_scores: torch.Tensor) -> torch.Tensor:
    """MSE on head-averaged scores, layer-averaged (every layer has the same
    shape, so the mean of the per-layer means is the overall mean)."""
    return (_head_mean(stu_scores) - _head_mean(tea_scores)).square().mean()


def attention_probs_mse(stu_probs: torch.Tensor, tea_probs: torch.Tensor) -> torch.Tensor:
    """The same on the probabilities."""
    return (_head_mean(stu_probs) - _head_mean(tea_probs)).square().mean()


def attention_probs_kl(stu_probs: torch.Tensor, tea_probs: torch.Tensor) -> torch.Tensor:
    """Per-layer sum-KL on head-averaged probabilities, layer-averaged."""
    s, t = _head_mean(stu_probs), _head_mean(tea_probs)
    return kl_div_sum(torch.log(s.clamp_min(1e-30)), t) / stu_probs.shape[0]


def hidden_rep_mse(stu_reps: torch.Tensor, tea_reps: torch.Tensor) -> torch.Tensor:
    """Layer-averaged MSE on hidden states."""
    return (stu_reps.float() - tea_reps.float()).square().mean()


def last_value_map_kl(stu_vm: torch.Tensor, tea_vm: torch.Tensor) -> torch.Tensor:
    """KL on the dim-1 softmax of the last value map ``[B, H, N, N]``: the map
    is softmaxed again, over the head axis (a reference quirk, kept)."""
    s = torch.log_softmax(stu_vm.float(), dim=1)
    t = torch.softmax(tea_vm.float(), dim=1)
    return kl_div_sum(s, t)


# -- contrastive / image-text losses ------------------------------------------------

def hard_label(stu_logits: torch.Tensor) -> torch.Tensor:
    """InfoNCE with the diagonal as labels."""
    labels = torch.arange(stu_logits.shape[0], device=stu_logits.device)
    return cross_entropy_mean(stu_logits, labels)


def soft_label(stu_logits: torch.Tensor, tea_logits: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """Sum-KL between the T-scaled contrastive distributions, · T²."""
    logp = torch.log(torch.softmax(stu_logits.float() / temperature, dim=1).clamp_min(1e-30))
    q = torch.softmax(tea_logits.float() / temperature, dim=1)
    return kl_div_sum(logp, q) * temperature ** 2


def logits_mse(stu_logits: torch.Tensor, tea_logits: torch.Tensor) -> torch.Tensor:
    """MSE between the similarity matrices."""
    return (stu_logits.float() - tea_logits.float()).square().mean()


def fine_grain(image_tokens: torch.Tensor, text_tokens: torch.Tensor) -> torch.Tensor:
    """ColBERT-style late interaction: sim[q, b] = mean_n max_m (query_tokens[q]
    · respond_tokens[b]ᵀ), cross entropy both ways with diagonal labels.  One
    einsum per direction: its fp32 ``[Q, B, N, M]`` similarity is the loss's
    memory (1.0 GB at 256 pairs of 50 and 77 tokens)."""

    def cal_similarity(query: torch.Tensor, respond: torch.Tensor) -> torch.Tensor:
        sim = torch.einsum("qnd,bmd->qbnm", query.float(), respond.float())
        return sim.max(dim=-1).values.mean(dim=-1)      # [Q, B]

    i2t = cal_similarity(image_tokens, text_tokens)
    t2i = cal_similarity(text_tokens, image_tokens)
    labels = torch.arange(i2t.shape[0], device=i2t.device)
    return 0.5 * (cross_entropy_mean(i2t, labels) + cross_entropy_mean(t2i, labels))


def _off_diagonal(x: torch.Tensor) -> torch.Tensor:
    """All off-diagonal elements of a square matrix, row by row."""
    n = x.shape[0]
    return x.reshape(-1)[:-1].reshape(n - 1, n + 1)[:, 1:].reshape(-1)


def cos_diff(stu_logits: torch.Tensor, tea_logits: torch.Tensor) -> torch.Tensor:
    """Hinge on cosine gaps: pull the diagonal up to the teacher's, push the
    off-diagonals below the teacher's."""
    s, t = stu_logits.float(), tea_logits.float()
    pos = torch.relu(torch.diagonal(t) - torch.diagonal(s)).mean()
    neg = torch.relu(_off_diagonal(s) - _off_diagonal(t)).mean()
    return pos + neg


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


def _pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dist[i, j] = ||a_i - b_j|| by the expanded square, clamped at 1e-12
    before the root."""
    a_sq, b_sq = (a * a).sum(dim=1, keepdim=True), (b * b).sum(dim=1, keepdim=True)
    return (a_sq + b_sq.t() - 2.0 * (a @ b.t())).clamp_min(1e-12).sqrt()


def _mined_logits(t: torch.Tensor, s: torch.Tensor, tau: float):
    """The two margin-weighted logit columns of :func:`smd`: the hardest
    negative and the hardest positive against the teacher's pairwise
    distances.  The weights are detached; ``argmin`` / ``argmax`` take the
    first index on a tie."""
    dist_t, dist = _pairwise_dist(t, t), _pairwise_dist(t, s)
    negative_index = (dist_t > torch.diagonal(dist)[:, None]).float()
    negative = torch.where(negative_index > 0, dist, 1e5)
    positive = dist * (1.0 - negative_index)
    an_idx = _first_arg(negative, torch.min)
    ap_idx = _first_arg(positive, torch.max)
    dist_an, dist_ap = negative.gather(1, an_idx)[:, 0], positive.gather(1, ap_idx)[:, 0]
    an_t, ap_t = dist_t.gather(1, an_idx)[:, 0], dist_t.gather(1, ap_idx)[:, 0]
    weight_an = torch.relu((an_t - dist_an).detach())
    weight_ap = torch.relu((dist_ap - ap_t).detach())
    return weight_an * dist_an / tau, weight_ap * dist_ap / tau


def _first_arg(x: torch.Tensor, extreme) -> torch.Tensor:
    """``[n, 1]`` index of each row's extreme value, the first one on a tie
    (torch's argmin / argmax promise no order among equal values)."""
    n = x.shape[1]
    hit = x == extreme(x, dim=1, keepdim=True).values
    cols = torch.arange(n, device=x.device).expand_as(x)
    return torch.where(hit, cols, n).min(dim=1, keepdim=True).values


def smd(tea_inputs: torch.Tensor, stu_inputs: torch.Tensor, tau: float = 0.04,
        normalized: bool = True) -> torch.Tensor:
    """Similarity-based metric distillation: hardest negative and positive
    mined against the teacher's pairwise-distance matrix, margin-weighted
    two-way cross entropy with label 0."""
    t, s = tea_inputs.float(), stu_inputs.float()
    if normalized:
        s, t = _unit_rows(s), _unit_rows(t)
    logits = torch.stack(_mined_logits(t, s, tau), dim=1)
    labels = torch.zeros(s.shape[0], dtype=torch.long, device=s.device)
    return cross_entropy_mean(logits, labels)


def smd_multi_model(tea_inputs: torch.Tensor, stu_inputs: torch.Tensor,
                    text_inputs: torch.Tensor, tau: float = 0.04,
                    normalized: bool = True) -> torch.Tensor:
    """Three-way SMD: :func:`smd`'s two columns and the student's image-text
    positive distance ``||img_i - txt_i||`` as the third (the reference's
    version cannot run; this is its evident intent, as ``PARITY.md`` records).
    Under ``normalized`` the text representations are normalised too, so the
    three columns share a scale."""
    t, s, x = tea_inputs.float(), stu_inputs.float(), text_inputs.float()
    if normalized:
        s, t, x = _unit_rows(s), _unit_rows(t), _unit_rows(x)
    text_positive = (s - x).square().sum(dim=1).clamp_min(1e-12).sqrt()
    logits = torch.stack([*_mined_logits(t, s, tau), text_positive / tau], dim=1)
    labels = torch.zeros(s.shape[0], dtype=torch.long, device=s.device)
    return cross_entropy_mean(logits, labels)
