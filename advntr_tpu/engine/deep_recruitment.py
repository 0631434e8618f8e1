"""DNN read recruitment (adVNTR-NN): per-locus MLP classifier that
pre-screens unmapped reads so Viterbi only runs on likely candidates.

Capability-equivalent to the reference's keras path
(advntr/deep_recruitment.py:59-80, 315-331; runtime use at
vntr_finder.py:192-233): the read embedding is a 4^6-dim binary 6-mer
presence vector and the model is Dense(100, relu) [-> Dense(50, relu)]
-> Dense(2, softmax).  Implemented in JAX: embeddings are computed batched
on device, training uses optax adam, checkpoints are .npz files.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp

KMER_LENGTH = 6
INPUT_DIM = 4 ** KMER_LENGTH


def embed_batch(seqs: np.ndarray, lengths: np.ndarray) -> jnp.ndarray:
    """Binary 6-mer presence embeddings, batched.

    seqs: (B, L) int8 codes; non-ACGT bases are treated as A (code 0),
    matching the reference's mapping quirk (deep_recruitment.py:66-69).
    """
    return _embed_batch(jnp.asarray(seqs), jnp.asarray(lengths))


@jax.jit
def _embed_batch(seqs, lengths):
    B, L = seqs.shape
    k = KMER_LENGTH
    n_pos = L - k + 1
    s = jnp.where(seqs < 4, seqs, 0).astype(jnp.int32)
    code = jnp.zeros((B, n_pos), dtype=jnp.int32)
    for j in range(k):
        code = code * 4 + jax.lax.dynamic_slice_in_dim(s, j, n_pos, axis=1)
    pos_ok = (jnp.arange(n_pos)[None, :] <= (lengths[:, None] - k))
    out = jnp.zeros((B, INPUT_DIM), dtype=jnp.float32)
    b_idx = jnp.broadcast_to(jnp.arange(B)[:, None], code.shape)
    out = out.at[b_idx, code].max(pos_ok.astype(jnp.float32))
    return out


def init_params(rng_key, first_layer: int = 100, second_layer: int = 0):
    keys = jax.random.split(rng_key, 3)
    scale = 0.05
    params = {
        "w1": jax.random.uniform(keys[0], (INPUT_DIM, first_layer),
                                 minval=-scale, maxval=scale),
        "b1": jnp.zeros(first_layer),
    }
    prev = first_layer
    if second_layer:
        params["w2"] = jax.random.uniform(keys[1], (prev, second_layer),
                                          minval=-scale, maxval=scale)
        params["b2"] = jnp.zeros(second_layer)
        prev = second_layer
    params["w_out"] = jax.random.uniform(keys[2], (prev, 2),
                                         minval=-scale, maxval=scale)
    params["b_out"] = jnp.zeros(2)
    return params


def forward(params, x):
    # default matmul precision: on a GPU the products may run in TF32
    # (~3 decimal digits), which is ample for a two-class argmax
    h = jax.nn.relu(x @ params["w1"] + params["b1"])
    if "w2" in params:
        h = jax.nn.relu(h @ params["w2"] + params["b2"])
    return jax.nn.softmax(h @ params["w_out"] + params["b_out"], axis=-1)


@jax.jit
def predict(params, embeddings):
    """(B, 2) softmax scores; class 0 = VNTR read
    (reference: is_true at deep_recruitment.py:333-334)."""
    return forward(params, embeddings)


def train(embeddings: np.ndarray, labels: np.ndarray, epochs: int = 3,
          batch_size: int = 10, learning_rate: float = 1e-3,
          second_layer: int = 0, seed: int = 0):
    """Train from scratch; labels are 1 for VNTR reads, 0 for decoys."""
    import optax
    params = init_params(jax.random.PRNGKey(seed), second_layer=second_layer)
    onehot = np.stack([labels, 1 - labels], axis=1).astype(np.float32)
    opt = optax.adam(learning_rate)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, x, y):
        def loss_fn(p):
            probs = forward(p, x)
            return -jnp.mean(jnp.sum(y * jnp.log(probs + 1e-9)
                                     + (1 - y) * jnp.log(1 - probs + 1e-9),
                                     axis=-1))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    n = len(embeddings)
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n, batch_size):
            idx = order[i:i + batch_size]
            params, opt_state, _ = step(params, opt_state,
                                        jnp.asarray(embeddings[idx]),
                                        jnp.asarray(onehot[idx]))
    return params


def save_model(params, path: str) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def load_model(path: str):
    if not os.path.exists(path):
        return None
    data = np.load(path)
    return {k: jnp.asarray(data[k]) for k in data.files}
