"""The paper's own network: MNIST deep-belief autoencoder (Hinton 784-1000-500-250-30)
pre-trained layer-wise with RBM CD-1, then unrolled + fine-tuned (Figs. 6/10/12); the
classifier variant appends a 10-way softmax (Figs. 7/9/11)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mnist-dbn",
    family="dbn",
    n_layers=4,
    d_model=784,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=10,
    norm="none",
    source="paper §IV + Hinton & Salakhutdinov 2006",
)

# layer widths of the stack (input -> code)
STACK = (784, 1000, 500, 250, 30)
N_CLASSES = 10
