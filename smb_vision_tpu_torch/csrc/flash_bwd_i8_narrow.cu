// K7's instantiations for heads narrower than their instantiation's width
// (flash_bwd_i8_sm90_kernel<D, true>: d 8 to 120 but 32 and 64, see the
// note at the top of flash_bwd.cu), compiled in a translation unit of
// their own so that K7's kernels for full-width heads keep their SASS.
// smb_flash_bwd_i8 (flash_bwd.cu) calls smb_flash_bwd_i8_narrow.

#define SMB_FLASH_BWD_I8_NARROW
#include "flash_bwd.cu"
