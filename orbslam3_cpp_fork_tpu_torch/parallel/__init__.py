"""Scale-out (port of the reference's parallel/): the whole-map bundle
adjustments with their observation set sharded over the ranks of a
`torch.distributed` process group (`dist_ba`), and a launcher that runs one
function in a group of spawned ranks on the card or the CPU (`launch`)."""
