"""Launch: meshes and sharding rules, step builders and the training
driver."""
