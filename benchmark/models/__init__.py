"""The served models: one module a configuration `model_type`,
`models/<model_type>.py`, loaded by its path (`common.served_model`).
A served model joins the benchmark through such a file, with its
configuration, reference, traffic, limits and readers, and no edit to
the harness.

A module holds five functions; `dims` are the sizes under the port's
names, the dict the module's own functions and the readers
(`ctx["dims"]`) get:

- `dims(config) -> dict`: from the configuration file's keys; it holds
  at least `vocab_size` (the traffic draws token ids below it) and
  `max_len`.
- `make_params(dims, seed, device, dtype)`: the program's weights,
  drawn from the seed on the device in a few large calls.
- `make_engine(params, dims, dtype, device, serving)`: the port's
  `InferenceEngine` over those weights, with its `decode_loop`.
  `serving` is the configuration's whole `serving` dict (`slots`,
  `page_size`, `kv_pages` and whatever keys of its own the model reads).
- `reference_params(dims, seed, device, dtype)`: the plain reference's
  float32 copy of the same weights, drawn again from the seed (nothing
  the program made).
- `served_gaps(params32, dims, prompt, served, precision="float32",
  ref_logits=None)`: for each served token of one request, how far the
  float32 reference's logit of it lies below the reference's best at its
  position; with `precision="fp8"` the tokens judged are the ones the
  float8 control puts first there. Returns (gaps, the float32 logits at
  the served positions, which a second call reuses as `ref_logits`).

The arithmetic of a model's own readers (its FLOPs, its kernels' work)
lives in its module or a file beside it.
"""
