from slimt_jax.io.marian import Item, load_items, save_items  # noqa: F401
from slimt_jax.io.loader import load_weights  # noqa: F401
