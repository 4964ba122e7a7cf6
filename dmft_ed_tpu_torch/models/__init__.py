"""Model drivers of the port.

  hm_bethe            single/multi-band Bethe-lattice Hubbard (canonical)
  ahm_bethe           attractive-U superconducting Bethe (ed_mode=superc)
"""
