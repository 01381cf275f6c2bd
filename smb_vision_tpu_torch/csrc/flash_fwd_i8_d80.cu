// K3's instantiations on the d-80 tiles (flash_fwd_sm90_kernel<80, true,
// NARROW>: heads of 72 and 80 on int8 codes of 96 bytes, see the note at
// the top of flash_fwd.cu), compiled in a translation unit of their own so
// that the kernels of the other widths keep their SASS. smb_flash_fwd
// (flash_fwd.cu) calls smb_flash_fwd_i8_d80.

#define SMB_FLASH_FWD_I8_D80
#include "flash_fwd.cu"
