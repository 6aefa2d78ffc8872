"""Entry points of the port's LLM serving path (`serve`), its training
(`train`) and its dry run on the meta device (`dryrun`, with the input
shapes `input_specs` and the sharding rules `shardings`), the step
functions they drive (`steps`), and the meshes and the card's roofline
constants (`mesh`)."""
