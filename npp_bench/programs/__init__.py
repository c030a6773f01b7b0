"""The kinds of program the benchmark drives, one module each, found by name:
a traffic file's `entry` names `programs/<entry>.py` (harness.kind). A new
kind is a new module here and its own configuration, traffic, limits and
metric files; no file of the harness changes.

A kind provides, as module attributes:

 - make_inputs(config, traffic, seed, device): everything the run makes
   from the seed (data, weights), handed to the program and to the plain
   reference alike;
 - staged(inputs, directory): a context manager under which the program
   runs: it writes what the port reads from disk (the towers' weights,
   where the port's weight source reads them) into `directory`, the run's
   own, removed after the window;
 - build(config, traffic, inputs, device): the program, an object with
   run_block(state, feed) -> {'loss': a tensor}, state, feed, images,
   block and table (program.Fit is the fits'). A block runs `block` steps
   of `images` each; the harness counts block x images image-steps a block
   (for a ranking: candidates x steps, its eval inside the block);
 - first_block(program, config, traffic, device): drives the first block
   through run_block with the program's own state and feed, and returns
   what it read of it, on the host; the window then goes on from that
   state;
 - check(config, traffic, inputs, record, device): with the program freed,
   runs the plain reference (which imports nothing of the port and takes
   nothing it made) and returns (numbers, diagnostics): every number
   compared or reported, by name;
 - limits(bench_dir, cell): {number: limit} of the compared numbers,
   limits/<cell>.json;
 - work(config, traffic): the work the per-layer readers divide by,
   counted from the configuration, never from the port:
     {'flops': {part: operations of one image-step, ..., 'total': ...},
      'peak': the peaks.json entry the step's products run at ('tf32'),
      'kernels': {'K2': [{'rows', 'width', 'precision'}],
                  'K3': [{'n', 'p', 'q', 'c', 'dx', 'dy', 'masked',
                          'precision'}], ...}}
   each kernel item the work of one step of the block (every image
   stacked in it), with 'per_step' calls a step where it is not 1. A
   reader whose kernel the kind does not declare returns None;
 - calibrate(cell, config, traffic, seed, device): one seed's readings of
   the program, the control and the planted faults, each compared with the
   reference, which the limits are set from (calibrate.py).

The kinds here: fit_block and batched_fit_block, the port's fits (fit.py
holds what they share, program.py their build).
"""
