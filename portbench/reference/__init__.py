"""Plain float32 forwards of the model families, one file each.  They
import neither JAX, nor the JAX package, nor anything of the port: they
read the configuration's file and the weights the harness drew."""
