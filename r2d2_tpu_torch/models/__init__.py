"""Model layer: the R2D2 network as torch.nn.Modules (port of
r2d2_tpu/models). Parameters keep the JAX package's layouts where they
matter for conversion (interop.py): the LSTM's wi (D,4H), wh (H,4H) and one
bias b in i,f,g,o order, and NHWC observations at the public functions."""
