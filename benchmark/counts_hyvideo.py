"""Frozen yardsticks of HunyuanVideo's MM-DiT (`configs/hunyuanvideo-
t2v-13b.json`): its FLOP model and the least time of each of its kernels'
launches over one Euler step, from operations and bytes at the traffic's
shapes, with `counts.py`'s peaks.

One sampling step of batch 1 over `n_img` video tokens and the `n_txt`
valid text tokens (L = n_img + n_txt) runs 20 double-stream blocks and 40
single-stream blocks over all L rows, the token refiner over the text
rows, and the embedders and final layer; the text's projection into the
refiner and the CLIP and guidance embedders run once a request. Every
token meets, in each of the 60 blocks, 4·D² + 2·D·F multiply-adds of its
stream's (or the single block's) linear layers, and every pair of rows
meets 2·D in each of the two products of attention.
"""

from __future__ import annotations

from typing import Dict

from benchmark import counts


def dims(c: Dict):
    """(D, heads, head_dim, F, blocks)."""
    d, h = c["hidden_size"], c["heads_num"]
    return (d, h, d // h, int(d * c["mlp_width_ratio"]),
            c["mm_double_blocks_depth"] + c["mm_single_blocks_depth"])


def step_flops(c: Dict, n_img: int, n_txt: int) -> float:
    """FLOPs of one Euler step (one forward at batch 1)."""
    d, _, _, f, nb = dims(c)
    nd, ns = c["mm_double_blocks_depth"], c["mm_single_blocks_depth"]
    fe = c["frequency_embedding_size"]
    l = n_img + n_txt
    blocks = nb * (l * 2 * (4 * d * d + 2 * d * f) + 4 * l * l * d)
    mods = 2 * d * d * (nd * 2 * 6 + ns * 3 + 2)
    refiner = c["refiner_depth"] * (n_txt * 2 * (4 * d * d + 2 * d * f)
                                    + 4 * n_txt * n_txt * d
                                    + 2 * d * 2 * d)
    embed = 2 * 2 * (fe * d + d * d)  # time_in, the refiner's t_embedder
    pdim = c["in_channels"]
    for p in c["patch_size"]:
        pdim *= p
    patches = n_img * 2 * pdim * d * 2  # img_in, final_layer.linear
    return float(blocks + mods + refiner + embed + patches)


def request_flops(c: Dict, n_txt: int) -> float:
    """FLOPs a request runs once: the text's projection into the refiner,
    its context vector, the CLIP vector's and the guidance's embedders."""
    d = c["hidden_size"]
    td, td2 = c["text_states_dim"], c["text_states_dim_2"]
    fe = c["frequency_embedding_size"]
    return float(2 * n_txt * td * d + 2 * (td * d + d * d)
                 + 2 * (td2 * d + d * d) + 2 * (fe * d + d * d))


# least seconds of one step's launches of each kernel

def attention_step_bound(c: Dict, n_img: int, n_txt: int) -> float:
    """The joint attention of each block (L × L, all heads) and the
    refiner's (n_txt × n_txt), forward only."""
    _, h, hd, _, nb = dims(c)
    l = n_img + n_txt
    return (nb * counts.attention_bound(1, h, l, l, hd, False)
            + c["refiner_depth"]
            * counts.attention_bound(1, h, n_txt, n_txt, hd, False))


def qknorm_rope_step_bound(c: Dict, n_img: int, n_txt: int) -> float:
    """One launch a block over L rows: q and k (2·D columns) read and
    written once in bf16, the video rows' cos and sin (fp32, head_dim/2 a
    row) and four norm weights read once; ~8 fp32 flops an element."""
    d, _, hd, _, nb = dims(c)
    l = n_img + n_txt
    nbytes = 2 * l * 2 * d * 2 + 2 * n_img * (hd // 2) * 4 + 4 * hd * 2
    return nb * counts.bound_s(nbytes, 0, 8 * l * 2 * d)


def ln_modulate_step_bound(c: Dict, n_img: int, n_txt: int) -> float:
    """Each launch reads x and writes y once in bf16 (shift and scale are
    [D]): a double block's four (both streams, twice), a single block's
    one over L rows, the final layer's over the video rows."""
    d = c["hidden_size"]
    l = n_img + n_txt
    nd, ns = c["mm_double_blocks_depth"], c["mm_single_blocks_depth"]
    rows = nd * 2 * l + ns * l + n_img
    launches = nd * 4 + ns + 1
    return counts.bound_s(2 * rows * d * 2 + launches * 2 * d * 2)


def gelu_tanh_step_bound(c: Dict, n_img: int, n_txt: int) -> float:
    """Each launch reads its [rows, F] input (and a double block's fc1
    bias) and writes its output once in bf16; ~20 fp32 flops an element:
    every row once in every block."""
    _, _, _, f, nb = dims(c)
    nd = c["mm_double_blocks_depth"]
    n = nb * (n_img + n_txt) * f
    return counts.bound_s(2 * n * 2 + nd * 2 * f * 2, 0, 20 * n)

