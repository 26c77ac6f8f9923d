"""Architecture configs: the five LM archs, and the registry that names them."""
