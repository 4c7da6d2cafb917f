"""The LDMBert text tower and its WordPiece tokenizer, against the JAX
package, on the CPU.

* Token ids of `models.bert_tokenizer` bit for bit with the JAX
  ``BertWordPieceTokenizer`` (basic tokenization, WordPiece, [CLS]/[SEP]/
  [PAD], truncation at 77).
* The tower on shared weights (the JAX init's parameters through
  `ldm_bert_params_from_jax`) against the JAX package's own pieces
  (``LDMBertSelfAttention``, flax Dense and LayerNorm) composed as diffusers
  composes them: pre-LN layers and LayerNorm epsilon 1e-5; atol 2e-5 on
  hidden states of unit scale. The JAX ``LDMBertEncoder`` itself is post-LN
  with flax's epsilon 1e-6, two reference defects the port does not
  reproduce (ROADMAP C4): its output differs from the composition by far
  more than the tolerance, and its epsilon by more than the JAX package's
  own 2e-4 oracle tolerance hides at small variance.
* A diffusers ``LDMBertModel`` state dict (``model.`` prefix, ``to_logits``
  head) and the JAX ``.npz`` load into the port's names, bit for bit with
  the JAX converter; the default spec's parameter count; ids outside the
  vocabulary raise.
* `pipelines.ImagenetteCaptioner` against the JAX captioner.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from group_attribution_for_diffusion_models_tpu import pipelines as jax_pipelines
from group_attribution_for_diffusion_models_tpu.models import ldm_bert as jax_ldm_bert
from group_attribution_for_diffusion_models_tpu.models.bert_tokenizer import (
    BertWordPieceTokenizer as JaxWordPiece,
)
from group_attribution_for_diffusion_models_tpu_torch import pipelines
from group_attribution_for_diffusion_models_tpu_torch.models.bert_tokenizer import (
    BertWordPieceTokenizer,
)
from group_attribution_for_diffusion_models_tpu_torch.models.convert_diffusers import (
    ldm_bert_params_from_jax,
)
from group_attribution_for_diffusion_models_tpu_torch.models.ldm_bert import (
    LN_EPS,
    LDMBertEncoder,
    ldm_bert_spec,
    load_ldm_bert,
)

ATOL = 2e-5
SMALL = dict(vocab_size=40, max_positions=77, d_model=32, layers=2, num_heads=8,
             head_dim=4, ffn_dim=128)
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "photo", "of", ".", "tench", "english",
         "spring", "##er", "cassette", "play", "##er", "chain", "saw", ",", "church",
         "french", "horn", "garbage", "truck", "gas", "pump", "golf", "ball", "para",
         "##chute", "!", "cafe", "naive", "中", "文", "##s", "un", "##believ", "##able"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_vocab(directory, words=VOCAB) -> str:
    """A vocab.txt of `words`, one a line (a repeated word keeps its last
    id, as both tokenizers read the file)."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "vocab.txt").write_text("\n".join(words) + "\n", encoding="utf-8")
    return str(directory)


class PreLNLayer(nn.Module):
    """A diffusers LDMBert layer of the JAX package's own pieces."""

    num_heads: int
    head_dim: int
    ffn_dim: int

    @nn.compact
    def __call__(self, x):
        h = nn.LayerNorm(epsilon=LN_EPS, name="self_attn_layer_norm")(x)
        x = x + jax_ldm_bert.LDMBertSelfAttention(self.num_heads, self.head_dim,
                                                  name="self_attn")(h)
        h = nn.LayerNorm(epsilon=LN_EPS, name="final_layer_norm")(x)
        h = nn.gelu(nn.Dense(self.ffn_dim, name="fc1")(h), approximate=False)
        return x + nn.Dense(x.shape[-1], name="fc2")(h)


class PreLNEncoder(nn.Module):
    """The JAX LDMBertEncoder's fields and parameter names, with diffusers'
    pre-LN layers and LayerNorm epsilon."""

    vocab_size: int = 30522
    max_positions: int = 77
    d_model: int = 1280
    layers: int = 32
    num_heads: int = 8
    head_dim: int = 64
    ffn_dim: int = 5120
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, input_ids):
        tok = nn.Embed(self.vocab_size, self.d_model, name="embed_tokens")(input_ids)
        pos = self.param("embed_positions", nn.initializers.normal(0.02),
                         (self.max_positions, self.d_model), jnp.float32)
        h = tok + pos[None, : input_ids.shape[1]]
        for i in range(self.layers):
            h = PreLNLayer(self.num_heads, self.head_dim, self.ffn_dim, name=f"layer_{i}")(h)
        return nn.LayerNorm(epsilon=LN_EPS, name="layer_norm")(h)


def jax_params(seed=0, **config):
    ids = jnp.zeros((1, 77), jnp.int32)
    params = jax_ldm_bert.LDMBertEncoder(**config).init(jax.random.PRNGKey(seed), ids)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def port_tower(params, **config):
    model = LDMBertEncoder(**config)
    model.load_state_dict(ldm_bert_params_from_jax(params))
    return model.eval()


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("text", [
    "a photo of a tench.",
    "A Photo of an English Springer!",
    "  cassette   player,chain saw\tchurch\n",
    "Café naïve unbelievable",
    "中文s and an unknownword",
    "para" * 30,
    " ".join(["golf ball"] * 60),  # past 77 ids: truncated, [SEP] kept
])
def test_wordpiece_ids_match_jax_bit_for_bit(tmp_path, text):
    vocab = write_vocab(tmp_path)
    got = BertWordPieceTokenizer.from_dir(vocab)([text, "a photo of a gas pump."])
    want = JaxWordPiece.from_dir(vocab)([text, "a photo of a gas pump."])
    assert got.dtype == want.dtype == np.int32 and got.shape == (2, 77)
    np.testing.assert_array_equal(got, want)


def test_tower_is_pre_ln_with_diffusers_epsilon():
    """The port against the pre-LN composition of the JAX pieces (atol
    2e-5); the JAX LDMBertEncoder (post-LN, eps 1e-6) is far from both."""
    params = jax_params(**SMALL)
    ids = np.random.default_rng(0).integers(0, SMALL["vocab_size"], (3, 77)).astype(np.int32)
    want = np.asarray(PreLNEncoder(**SMALL).apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = port_tower(params, **SMALL)(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    jax_post_ln = np.asarray(jax_ldm_bert.LDMBertEncoder(**SMALL).apply(
        {"params": params}, jnp.asarray(ids)))
    assert np.abs(jax_post_ln - want).max() > 100 * ATOL
    port = port_tower(params, **SMALL)
    assert {m.eps for m in port.modules() if isinstance(m, torch.nn.LayerNorm)} == {1e-5}


def test_layer_norm_epsilon_is_diffusers_not_flax():
    """At a small activation variance, flax's 1e-6 and torch's 1e-5 part by
    more than the JAX oracle's 2e-4 (tests/test_convert_numeric.py): the
    port's final LayerNorm follows torch's."""
    x = np.random.default_rng(1).standard_normal((2, 5, 32)).astype(np.float32) * 3e-3
    port = port_tower(jax_params(**SMALL), **SMALL).layer_norm
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    for eps, close in ((1e-5, True), (1e-6, False)):
        ln = nn.LayerNorm(epsilon=eps)
        want = np.asarray(ln.apply(ln.init(jax.random.PRNGKey(0), x), x))
        assert np.allclose(got, want, atol=2e-4, rtol=0) == close


def test_diffusers_state_dict_and_jax_npz_load(tmp_path):
    params = jax_params(3, **SMALL)
    want = ldm_bert_params_from_jax(params)
    diffusers = {f"model.{k}": v.clone() for k, v in want.items()}
    diffusers["to_logits.weight"] = torch.zeros(SMALL["vocab_size"], SMALL["d_model"])
    diffusers["to_logits.bias"] = torch.zeros(SMALL["vocab_size"])
    path = str(tmp_path / "ldm_bert.pt")
    torch.save(diffusers, path)
    # The JAX converter reads the same file into the tree the bridge started from.
    jax_tree = jax_ldm_bert.convert_ldm_bert_state_dict(diffusers)
    assert flatten(jax.tree_util.tree_map(np.asarray, jax_tree)).keys() == flatten(params).keys()
    for k, v in flatten(jax.tree_util.tree_map(np.asarray, jax_tree)).items():
        np.testing.assert_array_equal(v, flatten(params)[k])
    npz = str(tmp_path / "ldm_bert.npz")
    np.savez(npz, **flatten(params))
    for file in (path, npz):
        tower = load_ldm_bert(file, device="cpu", **SMALL)
        assert not any(p.requires_grad for p in tower.parameters())
        for k, v in tower.state_dict().items():
            assert torch.equal(v, want[k]), (file, k)
    with pytest.raises(SystemExit, match="does not match the 32-wide LDMBert"):
        load_ldm_bert(npz, device="cpu", **dict(SMALL, ffn_dim=64))


def test_default_spec_parameter_count_and_the_cli_sizes():
    with torch.device("meta"):
        tower = LDMBertEncoder()
    assert sum(p.numel() for p in tower.parameters()) == 542_895_360
    assert ldm_bert_spec(1280) == dict(d_model=1280, layers=32, num_heads=8, head_dim=64,
                                       ffn_dim=5120)
    assert ldm_bert_spec(32) == dict(d_model=32, layers=2, num_heads=8, head_dim=4,
                                     ffn_dim=128)


def test_ids_outside_the_vocabulary_raise():
    tower = load_ldm_bert(None, device="cpu", quiet=True, **SMALL)
    with pytest.raises(ValueError, match="outside LDMBert's vocabulary of 40"):
        tower(torch.tensor([[2, 49406, 3]]))


def test_captioner_matches_jax():
    got, want = pipelines.ImagenetteCaptioner(), jax_pipelines.ImagenetteCaptioner()
    assert got.num_classes == want.num_classes == 10
    idx = [0, 3, 9, 5, 5]
    assert got(idx) == want(idx)
    assert got([0]) == ["a photo of a tench."]
